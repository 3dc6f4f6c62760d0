"""Parity of the port's conv-LDS (BASELINE config 4 at the
``conv_lds_smoke`` preset: the conv recognizer of
svae_tpu_torch/nets/recognition.py, ``models.lds.run_inference`` on the
stationary E-step, ``decoders.make_mlp_loglike``) with the JAX package, on
the CPU, in float64: one ``make_gradfun`` (ELBO, natural gradient, net
gradients, terms) against the JAX package's with ``backend="xla"`` on the
same parameters and noise (the JAX side draws it from its key; the port is
given the same draws through ``eps=``), at rtol 1e-8 / atol 1e-10; and the
example script's dataset, ``make_2d_dot_movies``, equal to the JAX
script's.

The JAX reference is one XLA program compiled once in a module fixture,
without XLA's backend optimizations, with the JAX package's Cholesky on
its library route (tests/_jax_cholesky.py): the unrolled scalar algebra
would double the trace and compile and computes the same float64 values
to rounding.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svae_tpu.config import PRESETS as JAX_PRESETS
from svae_tpu.models import lds as jax_lds
from svae_tpu.nets import decoders as jax_decoders
from svae_tpu.nets import recognition as jax_recognition
from svae_tpu.train import elbo as jax_elbo

from svae_tpu_torch import convert
from svae_tpu_torch.config import PRESETS
from svae_tpu_torch.data.synthetic import make_2d_dot_movies
from svae_tpu_torch.models import lds
from svae_tpu_torch.nets import decoders, recognition
from svae_tpu_torch.train import elbo

from tests.test_torch_conv import F64, _close, _conv_params, _mlp_params

# autouse: this module's JAX references trace the JAX package's
# Cholesky on its library route
from tests._jax_cholesky import jax_library_cholesky

torch.set_num_threads(1)
SMOKE = PRESETS["conv_lds_smoke"]
S = SMOKE.train.num_samples


@pytest.fixture(scope="module")
def refs():
    rng = np.random.default_rng(18)
    c = SMOKE
    B, N = c.train.batch_size, c.num_seqs
    rec = _conv_params(rng, c.frame_hw, c.channels, c.d_latent,
                       k=c.kernel_size)
    dec = _mlp_params(rng, (c.d_latent,) + c.hidden_dec
                      + (c.frame_hw[0] * c.frame_hw[1],))
    y = make_2d_dot_movies(0, N, c.T, c.frame_hw)[:B].astype(np.float64)
    key = jax.random.key(5)

    def references(rec, dec, y):
        k1, k2 = jax.random.split(jax.random.key(3))
        prior = jax_lds.init_pgm_param(k1, c.d_latent, dtype=jnp.float64)
        glob = jax_lds.init_pgm_param(k2, c.d_latent, dtype=jnp.float64)
        gradfun = jax_elbo.make_gradfun(
            functools.partial(jax_lds.run_inference, backend="xla"),
            jax_recognition.make_conv_recognize(c.frame_hw),
            jax_decoders.make_mlp_loglike(), prior, N, num_samples=S)
        eps = jnp.stack([jax.random.normal(kb, (S, c.T, c.d_latent),
                                           jnp.float64)
                         for kb in jax.random.split(key, B)], 1)
        return dict(prior=prior, glob=glob, eps=eps,
                    grad=gradfun(glob, (rec, dec), y, key))

    out = jax.tree.map(np.asarray, jax.jit(references).lower(
        rec, dec, y).compile({"xla_backend_optimization_level": 0})(
            rec, dec, y))
    return dict(out, rec=rec, dec=dec, y=y)


def test_conv_lds_gradfun_matches_jax(refs):
    """One SVI gradient of the conv-LDS at conv_lds_smoke: the port's
    stationary E-step (the plain twins of #1-#4 on the CPU) against the
    JAX package's XLA scan, ELBO, natural gradient, net gradients and
    terms."""
    c = SMOKE
    natparam = functools.partial(convert.natparam, **F64)
    nets = (convert.conv_recognizer(refs["rec"], **F64),
            convert.decoder(refs["dec"], **F64))
    gradfun = elbo.make_gradfun(
        functools.partial(lds.run_inference,
                          eps=torch.tensor(refs["eps"])),
        recognition.make_conv_recognize(c.frame_hw),
        decoders.make_mlp_loglike(), natparam(refs["prior"]), c.num_seqs,
        num_samples=S)
    val, nat, net_grads, terms = gradfun(natparam(refs["glob"]), nets,
                                         torch.tensor(refs["y"]), None)
    r_val, r_nat, r_grads, r_terms = refs["grad"]
    _close(val, r_val)
    _close(nat, r_nat)
    rec_g, dec_g = net_grads
    n_conv = len(c.channels)
    rec_g = (tuple((W.permute(2, 3, 1, 0), b) for W, b in
                   zip(rec_g[:2 * n_conv:2], rec_g[1:2 * n_conv:2])),
             ((rec_g[-4], rec_g[-3]), (rec_g[-2], rec_g[-1])))
    _close((rec_g, dec_g), r_grads)
    assert set(terms) == set(r_terms)
    for k in terms:
        _close(terms[k], r_terms[k])


def test_make_2d_dot_movies_is_the_example_scripts():
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "conv_lds.py")
    spec = importlib.util.spec_from_file_location("_jax_conv_lds", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    np.testing.assert_array_equal(make_2d_dot_movies(4, 3, 7, (5, 6)),
                                  mod.make_2d_dot_movies(4, 3, 7, (5, 6)))
    assert JAX_PRESETS["conv_lds_smoke"].frame_hw == SMOKE.frame_hw
