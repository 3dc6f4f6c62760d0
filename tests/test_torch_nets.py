"""Parity of the port's recognizer, decoder and decoder log-likelihood with
the JAX package, in float64 on the CPU, with the JAX parameters carried
over by svae_tpu_torch/convert.py. Tolerance rtol 1e-8 / atol 1e-10 (both
sides float64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svae_tpu.nets import decoders as jax_decoders
from svae_tpu.nets import recognition as jax_recognition

from svae_tpu_torch import convert
from svae_tpu_torch.models import lds, slds
from svae_tpu_torch.nets import decoders, mlp, recognition
from svae_tpu_torch.nets.mlp import softplus

torch.set_num_threads(1)
RTOL, ATOL = 1e-8, 1e-10
D_OBS, HIDDEN, D_LAT = 6, (8,), 3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def nets():
    k1, k2 = jax.random.split(jax.random.key(0))
    rp = jax_recognition.init_mlp_recognize(k1, D_OBS, HIDDEN, D_LAT,
                                            dtype=jnp.float64)
    # push one recognition unit's softplus pre-activation past 20, where
    # F.softplus would return its input instead of log(1 + e^x)
    (Wj, bj), head_h = rp[1]
    rp = (rp[0], ((Wj, bj.at[0].set(25.0)), head_h))
    dp = jax_decoders.init_mlp_decode(k2, D_LAT, HIDDEN, D_OBS,
                                      dtype=jnp.float64)
    f64 = dict(dtype=torch.float64, device="cpu")
    return (rp, dp, convert.recognizer(_np(rp), **f64),
            convert.decoder(_np(dp), **f64))


def test_recognizer_matches_jax(nets):
    rp, _, rec, _ = nets
    y = np.random.default_rng(0).standard_normal((2, 5, D_OBS))
    J, h = recognition.mlp_recognize(rec, torch.from_numpy(y))
    Jr, hr = jax_recognition.mlp_recognize(rp, jnp.asarray(y))
    assert float(J[..., 0].detach().min()) > 20.0     # the pinned unit
    _close(J, Jr)
    _close(h, hr)


def test_softplus_is_exact_above_threshold():
    x = torch.tensor([-30.0, 0.0, 20.5, 25.0], dtype=torch.float64)
    _close(softplus(x), jax.nn.softplus(jnp.asarray(x.numpy())))
    assert float(softplus(x)[3] - 25.0) > 0.0


@pytest.mark.parametrize("mean_fn", [None, "sigmoid"])
def test_decoder_matches_jax(nets, mean_fn):
    _, dp, _, dec = nets
    x = np.random.default_rng(1).standard_normal((2, 3, 5, D_LAT))
    fn_t = None if mean_fn is None else torch.sigmoid
    fn_j = None if mean_fn is None else jax.nn.sigmoid
    mu, ls = decoders.mlp_decode(dec, torch.from_numpy(x), mean_fn=fn_t)
    mur, lsr = jax_decoders.mlp_decode(dp, jnp.asarray(x), mean_fn=fn_j)
    _close(mu, mur)
    _close(ls, lsr)


@pytest.mark.parametrize("masked", [False, True])
def test_mlp_loglike_matches_jax(nets, masked):
    _, dp, _, dec = nets
    rng = np.random.default_rng(2)
    samples = rng.standard_normal((2, 3, 5, D_LAT))
    y = rng.standard_normal((3, 5, D_OBS))
    mask = (rng.random((3, 5)) > 0.3).astype(np.float64) if masked else None
    ll = decoders.mlp_loglike(
        dec, torch.from_numpy(samples), torch.from_numpy(y),
        mask=None if mask is None else torch.from_numpy(mask))
    llr = jax_decoders.mlp_loglike(dp, jnp.asarray(samples), jnp.asarray(y),
                                   mask=mask)
    _close(ll, llr)


def test_init_is_seeded_and_shaped():
    make = lambda seed: recognition.init_mlp_recognize(
        D_OBS, HIDDEN, D_LAT, torch.Generator().manual_seed(seed),
        device="cpu")
    a, b, c = make(0), make(0), make(1)
    x = torch.randn(4, D_OBS, generator=torch.Generator().manual_seed(9))
    Ja, ha = a(x)
    assert Ja.shape == ha.shape == (4, D_LAT) and bool((Ja > 0).all())
    torch.testing.assert_close(b(x), (Ja, ha), rtol=0, atol=0)
    assert not torch.allclose(c(x)[1], ha)
    dec = decoders.init_mlp_decode(D_LAT, HIDDEN, D_OBS,
                                   torch.Generator().manual_seed(0),
                                   device="cpu")
    mu, ls = dec(ha)
    assert mu.shape == ls.shape == (4, D_OBS)


INITS = {
    "init_pgm_param": lambda g, **kw: lds.init_pgm_param(D_LAT, g, **kw),
    "slds_init_pgm_param": lambda g, **kw: slds.init_pgm_param(3, D_LAT, g,
                                                               **kw),
    "init_dense": lambda g, **kw: mlp.init_dense(D_OBS, D_LAT, g, **kw),
    "init_mlp": lambda g, **kw: mlp.init_mlp((D_OBS,) + HIDDEN, g, **kw),
    "init_mlp_recognize": lambda g, **kw: recognition.init_mlp_recognize(
        D_OBS, HIDDEN, D_LAT, g, **kw),
    "init_mlp_decode": lambda g, **kw: decoders.init_mlp_decode(
        D_LAT, HIDDEN, D_OBS, g, **kw),
}


def _devices(made):
    if isinstance(made, torch.nn.Module):
        return {p.device.type for p in made.parameters()}
    return {t.device.type for t in jax.tree.leaves(made)}


@pytest.mark.parametrize("name", sorted(INITS))
def test_init_defaults_to_the_card(name):
    """The entry points run on the card unless asked for the CPU: with no
    ``device`` they place their tensors on "cuda" even when the generator
    is a CPU one, which raises where there is no card."""
    g = torch.Generator().manual_seed(0)
    assert _devices(INITS[name](g, device="cpu")) == {"cpu"}
    if torch.cuda.is_available():
        assert _devices(INITS[name](g)) == {"cuda"}
    else:
        with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
            INITS[name](g)


CONVERTS = {
    "natparam": lambda m, **kw: convert.natparam(
        ((np.eye(2), np.zeros(2)), np.ones(())), **kw),
    "recognizer": lambda m, **kw: convert.recognizer(_np(m[0]), **kw),
    "decoder": lambda m, **kw: convert.decoder(_np(m[1]), **kw),
}


@pytest.mark.parametrize("name", sorted(CONVERTS))
def test_convert_defaults_to_the_card(nets, name):
    """Parameters carried over from the JAX package land on the card
    unless the caller asks for the CPU, as the ``init_*`` entry points'
    do."""
    assert _devices(CONVERTS[name](nets, device="cpu")) == {"cpu"}
    if torch.cuda.is_available():
        assert _devices(CONVERTS[name](nets)) == {"cuda"}
    else:
        with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
            CONVERTS[name](nets)
