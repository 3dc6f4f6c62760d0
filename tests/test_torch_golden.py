"""The golden trajectories of tests/test_golden.py through the port's
training loop (svae_tpu_torch/train/loop.py ``run``), in float64 on the
CPU.

The JAX package's golden runs (``_gmm_run``, ``_lds_run``) are not run
here. Their initial parameters are made with ``jax.random`` exactly as
there and carried over by svae_tpu_torch/convert.py; the data are the
port's copies of the same generators. The sampling noise of each step is
replayed from the JAX loop's key splits (svae_tpu/train/loop.py ``run``:
``key, kperm = split(key)`` each epoch, ``key, kstep = split(key)`` each
step) and handed to the port's ``run_inference`` through ``eps=``:
``normal(kstep, (S, B, d))`` for the GMM (gmm.run_inference draws its
samples from the step key), and ``normal(k_b, (S, T, d))`` for sequence b
of ``split(kstep, B)`` for the LDS (lds.run_inference's scan path hands
each sequence's key to ``kalman.lds_sample``). The first and last ELBOs
are held to the pinned ``*_GOLDEN_*`` values at the golden test's RTOL.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from svae_tpu.models import gmm as jax_gmm
from svae_tpu.models import lds as jax_lds
from svae_tpu.nets import decoders as jax_decoders
from svae_tpu.nets import recognition as jax_recognition
from test_golden import (GMM_GOLDEN_FIRST, GMM_GOLDEN_LAST,
                         LDS_GOLDEN_FIRST, LDS_GOLDEN_LAST, RTOL)

from svae_tpu_torch import convert
from svae_tpu_torch.data.synthetic import make_dot_data, make_pinwheel
from svae_tpu_torch.models import gmm, lds
from svae_tpu_torch.nets import decoders, recognition
from svae_tpu_torch.train import loop

torch.set_num_threads(1)
F64 = dict(dtype=torch.float64, device="cpu")
EPOCHS, S = 4, 2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_side(init_pgm, pgm_kw, d_obs, d, num_batches, draw):
    """The golden run's initial prior, globals and nets, as the port's
    objects, and each step's noise, ``draw(kstep)``, in step order.

    The inits are ``init_pgm(k1)``, ``init_pgm(k2)`` and MLPs of width 20
    from ``split(k3)``, with ``k1, k2, k3 = split(PRNGKey(0), 3)``, made by
    one XLA program compiled without XLA's backend optimizations (they
    cost a third of the compile and change no float64 value here); the
    step keys are loop.run's from PRNGKey(7), and ``draw`` is compiled
    once for all of them."""

    def inits():
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
        ka, kb = jax.random.split(k3)
        return (init_pgm(k1, **pgm_kw[0]), init_pgm(k2, **pgm_kw[1]),
                jax_recognition.init_mlp_recognize(ka, d_obs, (20,), d,
                                                   dtype=jnp.float64),
                jax_decoders.init_mlp_decode(kb, d, (20,), d_obs,
                                             dtype=jnp.float64))

    prior, params, rec, dec = _np(jax.jit(inits).lower().compile(
        {"xla_backend_optimization_level": 0})())
    key, keys = jax.random.PRNGKey(7), []
    for _ in range(EPOCHS):
        key, _ = jax.random.split(key)
        for _ in range(num_batches):
            key, kstep = jax.random.split(key)
            keys.append(kstep)
    draw = jax.jit(draw)
    natparam = functools.partial(convert.natparam, **F64)
    return (natparam(prior), natparam(params),
            (convert.recognizer(rec, **F64), convert.decoder(dec, **F64)),
            [np.array(draw(k)) for k in keys])


def _replay(run_inference, noises):
    """``run_inference`` fed each step's noise in turn."""
    it = iter(noises)

    def run(prior, glob, pots, generator, num_samples):
        return run_inference(prior, glob, pots, generator, num_samples,
                             eps=torch.from_numpy(next(it)))

    return run


def _history(run, prior, params, nets, data, batch_size):
    opt_init, step = loop.make_train_step(
        run, recognition.mlp_recognize, decoders.mlp_loglike, prior,
        data.shape[0], num_samples=S, pgm_step_size=0.5, net_step_size=1e-2)
    *_, hist, _ = loop.run(step, params, nets, opt_init(params, nets), data,
                           None, EPOCHS, batch_size, shuffle=False)
    return hist


def test_gmm_golden_trajectory():
    """tests/test_golden.py ``_gmm_run``: pinwheel (100 points), K=6, d=2,
    15 mean-field sweeps, B=50, 8 steps."""
    B, d = 50, 2
    data = torch.from_numpy(make_pinwheel(seed=1, num_per_class=20)
                            .astype(np.float64))
    prior, params, nets, noises = _jax_side(
        functools.partial(jax_gmm.init_pgm_param, K=6, d=d,
                          dtype=jnp.float64),
        ({}, dict(random_scale=2.0)), 2, d, data.shape[0] // B,
        lambda k: jax.random.normal(k, (S, B, d), jnp.float64))
    run = _replay(functools.partial(gmm.run_inference,
                                    num_meanfield_iters=15), noises)
    hist = _history(run, prior, params, nets, data, B)
    assert len(hist) == len(noises)
    np.testing.assert_allclose(hist[0], GMM_GOLDEN_FIRST, rtol=RTOL)
    np.testing.assert_allclose(hist[-1], GMM_GOLDEN_LAST, rtol=RTOL)


def test_lds_golden_trajectory():
    """tests/test_golden.py ``_lds_run``: 16 dot sequences (T=20, 10
    pixels), d=3, B=8, 8 steps."""
    B, T, d = 8, 20, 3
    data = torch.from_numpy(make_dot_data(seed=1, num_seqs=16, T=T,
                                          image_width=10).astype(np.float64))
    prior, params, nets, noises = _jax_side(
        functools.partial(jax_lds.init_pgm_param, d=d, dtype=jnp.float64),
        ({}, {}), 10, d, data.shape[0] // B,
        lambda k: jnp.stack([jax.random.normal(kb, (S, T, d), jnp.float64)
                             for kb in jax.random.split(k, B)], 1))
    hist = _history(_replay(lds.run_inference, noises), prior, params, nets,
                    data, B)
    assert len(hist) == len(noises)
    np.testing.assert_allclose(hist[0], LDS_GOLDEN_FIRST, rtol=RTOL)
    np.testing.assert_allclose(hist[-1], LDS_GOLDEN_LAST, rtol=RTOL)
