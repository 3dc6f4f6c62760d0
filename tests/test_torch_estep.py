"""Parity of the port's packed E-step (svae_tpu_torch/ops/estep.py) with
svae_tpu/ops/pallas_estep.py, in float64 on the CPU.

On the CPU the kernel wrappers run their plain twins; the JAX references
run the Pallas kernels in interpret mode, each once per module. Tolerance
rtol 1e-8 / atol 1e-10: both sides are float64, and LAPACK's Cholesky
rounds differently from the kernels' unrolled one. The kernels themselves
are checked on a card by tests/test_torch_kernels.py.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svae_tpu.expfam import mniw as jax_mniw
from svae_tpu.expfam import niw as jax_niw
from svae_tpu.models import lds as jax_lds
from svae_tpu.ops import pallas_estep

from svae_tpu_torch.ops import estep

torch.set_num_threads(1)
RTOL, ATOL = 1e-8, 1e-10
B, T, d, S = 3, 7, 3, 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.fixture(scope="module")
def problem():
    """One small chain problem; every JAX interpret-mode reference is
    computed here once."""
    rng = np.random.default_rng(0)
    glob = jax_lds.init_pgm_param(jax.random.key(0), d, dtype=jnp.float64)
    (I1, I2), Ic = jax_niw.expected_gaussian_natparam(glob[0])
    init = (I1, I2, Ic)
    mats = jax_mniw.expected_pair_potential(glob[1])
    jd = np.logaddexp(rng.standard_normal((B, T, d)), 0.0) + 0.4
    h = rng.standard_normal((B, T, d))
    eps = rng.standard_normal((S, B, T, d))
    E1, E2, E3, _ = (np.asarray(m) for m in mats)

    # the filter's packed inputs in the port's layout ...
    A = np.stack([-2.0 * E3, -2.0 * E1])
    C = np.stack([-2.0 * E1, -2.0 * E3])
    D = np.stack([E2, E2.T])
    J0f = -2.0 * np.asarray(I1) + jd[:, 0, :, None] * np.eye(d)
    J0 = np.concatenate([J0f.reshape(B, d * d).T, np.zeros((d * d, B))], 1)
    h0 = np.concatenate([(np.asarray(I2) + h[:, 0]).T, np.zeros((d, B))], 1)
    jdT, hT = jd.transpose(1, 2, 0), h.transpose(1, 2, 0)   # (T, d, B)
    filt_in = (J0, h0, A, C, D, jdT, hT)

    # ... and in the Pallas kernel's: per-lane whole operands, node
    # streams with the backward half flipped in time
    lanes = lambda M: np.repeat(M.reshape(2, d * d).T, B, axis=1)
    stream = lambda x: np.concatenate([x[1:], x[::-1][:T - 1]], axis=-1)
    wfwd = (np.arange(2 * B) < B).astype(np.float64)[None]
    Jr, hr, ln = pallas_estep._filter_fwd_call(
        *(jnp.asarray(x) for x in (J0, h0, lanes(A), lanes(C), lanes(D),
                                   wfwd, stream(jdT), stream(hT))),
        d=d, U=1, interpret=True)

    # sampler inputs: the forward messages of frames 0..T-2, fresh noise
    Jf = np.concatenate([J0[None, :, :B], np.asarray(Jr)[:-1, :, :B]])
    hf = np.concatenate([h0[None, :, :B], np.asarray(hr)[:-1, :, :B]])
    epsb = rng.standard_normal((T - 1, d, S * B))
    xT = rng.standard_normal((d, S * B))
    samp_in = (E2, E3, Jf, hf, epsb, xT)
    tile = lambda x: np.concatenate([x] * S, axis=-1)
    whole = lambda M: np.broadcast_to(M.reshape(d * d, 1), (d * d, S * B))
    x_ref = pallas_estep._sampler_fwd_call(
        *(jnp.asarray(a) for a in (whole(E2), whole(E3), tile(Jf), tile(hf),
                                   epsb, xT)),
        d=d, U=1, interpret=True)

    @jax.jit     # one compile: eager dispatch takes several times longer
    def references(nodes, eps):
        return (pallas_estep.lds_estep_stationary(
                    init, mats, nodes, None, S, block_b=8, interpret=True,
                    eps=eps),
                pallas_estep.lds_moments_stationary(
                    init, mats, nodes, block_b=8, interpret=True))

    estep_ref, moments_ref = references((jnp.asarray(jd), jnp.asarray(h)),
                                        jnp.asarray(eps))
    return dict(
        init=tuple(_t(x) for x in init), mats=tuple(_t(m) for m in mats),
        jd=_t(jd), h=_t(h), eps=_t(eps),
        filt_in=tuple(_t(x) for x in filt_in), filt_ref=(Jr, hr, ln),
        samp_in=tuple(_t(x) for x in samp_in), samp_ref=x_ref,
        estep_ref=estep_ref, moments_ref=moments_ref)


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_filter_twin_matches_pallas_kernel(problem, direction):
    lanes = slice(0, B) if direction == "forward" else slice(B, 2 * B)
    launches = estep.filter_fwd.launches
    J, h, ln = estep.filter_fwd(*problem["filt_in"])
    assert estep.filter_fwd.launches == launches   # CPU: the twin ran
    Jr, hr, lnr = problem["filt_ref"]
    _close(J[..., lanes], Jr[..., lanes])
    _close(h[..., lanes], hr[..., lanes])
    _close(ln[lanes], lnr[0, lanes])


def test_sampler_twin_matches_pallas_kernel(problem):
    launches = estep.sampler_fwd.launches
    x = estep.sampler_fwd(*problem["samp_in"])
    assert estep.sampler_fwd.launches == launches
    _close(x, problem["samp_ref"])


def test_estep_matches_jax(problem):
    samples, stats, local_kl = estep.lds_estep_stationary(
        problem["init"], problem["mats"], (problem["jd"], problem["h"]),
        None, S, eps=problem["eps"])
    s_ref, st_ref, kl_ref = problem["estep_ref"]
    _close(samples, s_ref)
    _close(local_kl, kl_ref)
    for port, ref in zip(stats[0] + stats[1], jax.tree.leaves(st_ref)):
        _close(port, ref)


def test_moments_match_jax(problem):
    out = estep.lds_moments_stationary(problem["init"], problem["mats"],
                                       (problem["jd"], problem["h"]))
    for port, ref in zip(out, problem["moments_ref"]):
        _close(port, ref)


def test_estep_draws_noise_from_generator(problem):
    args = (problem["init"], problem["mats"], (problem["jd"], problem["h"]))
    draw = lambda seed: estep.lds_estep_stationary(
        *args, torch.Generator().manual_seed(seed), S)[0]
    torch.testing.assert_close(draw(5), draw(5), rtol=0, atol=0)
    assert not torch.allclose(draw(5), draw(6))
    with pytest.raises(ValueError, match="Generator"):
        estep.lds_estep_stationary(*args, None, S)


def _run_python(code, **env):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, **env})


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import svae_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    svae_tpu_torch.__path__, 'svae_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'svae_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    proc = _run_python(code)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 30


def test_cpu_runs_twins_and_build_raises_without_nvcc(tmp_path):
    code = (
        "import torch\n"
        "from svae_tpu_torch.models import lds\n"
        "from svae_tpu_torch.ops import _build, estep\n"
        "g = torch.Generator().manual_seed(0)\n"
        "glob = lds.init_pgm_param(3, g, dtype=torch.float64, "
        "device='cpu')\n"
        "pots = (torch.rand(2, 5, 3, dtype=torch.float64, generator=g) + .5,\n"
        "        torch.randn(2, 5, 3, dtype=torch.float64, generator=g))\n"
        "s, stats, gkl, lkl = lds.run_inference(glob, glob, pots, g, 2)\n"
        "assert torch.isfinite(s).all() and torch.isfinite(lkl)\n"
        "assert estep.filter_fwd.launches == 0\n"
        "assert estep.sampler_fwd.launches == 0\n"
        "assert estep.filter_fwd_plain.calls == 1\n"
        "assert estep.sampler_fwd_plain.calls == 1\n"
        f"_build.BUILD_DIR = {str(tmp_path / 'build')!r}\n"
        "try:\n"
        "    lib = _build.load_library()\n"
        "except RuntimeError as e:\n"
        "    assert 'nvcc not found' in str(e), e\n"
        "    print('raised')\n"
        "else:\n"
        "    raise SystemExit(f'load_library returned {lib!r}')\n")
    proc = _run_python(code, CUDA_HOME=str(tmp_path / "no_cuda"))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("raised")
    assert not (tmp_path / "build").exists()
