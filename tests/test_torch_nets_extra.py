"""Parity of the port's residual and linear nets and the isometric decoder
init (svae_tpu_torch/nets/mlp.py ``ResNet``, ``rand_partial_isometry``,
``init_gaussian_mlp_isometric``; recognition.py ``resnet_recognize``,
``linear_recognize``; decoders.py ``linear_decode``, ``linear_loglike``)
with the JAX package, in float64 on the CPU (rtol 1e-8 / atol 1e-10),
the JAX parameters carried over by svae_tpu_torch/convert.py; the bf16
residual recognizer against the JAX package's bf16 path in float32; and
the new inits' defaults. The JAX references are one XLA program on
parameters drawn by NumPy in the JAX package's layouts. Four tests, so
that xdist's ``--dist loadfile`` runs the file beside
tests/test_time_shard.py instead of ahead of it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svae_tpu.nets import decoders as jax_decoders
from svae_tpu.nets import mlp as jax_mlp
from svae_tpu.nets import recognition as jax_recognition

from svae_tpu_torch import convert
from svae_tpu_torch.nets import decoders, mlp, recognition

torch.set_num_threads(1)
TOL = dict(rtol=1e-8, atol=1e-10)
# a bf16 product rounds each operand to 8 bits: both sides round the same
# operands, and their float32 sums differ in order only
TOL_BF16 = dict(rtol=1e-5, atol=1e-5)
D_OBS, WIDTH, DEPTH, D_LAT = 6, 8, 2, 3


def _close(port, ref, tol=TOL):
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(r), **tol)


def _dense(rng, m, n):
    return (rng.standard_normal((m, n)) / np.sqrt(m),
            0.1 * rng.standard_normal(n))


@pytest.fixture(scope="module")
def nets():
    """Random parameters in the JAX package's layouts (NumPy float64), the
    inputs, and every JAX reference, one XLA program."""
    rng = np.random.default_rng(1)
    p = dict(
        resnet=((_dense(rng, D_OBS, WIDTH),
                 tuple((_dense(rng, WIDTH, WIDTH), _dense(rng, WIDTH, WIDTH))
                       for _ in range(DEPTH))),
                (_dense(rng, WIDTH, D_LAT), _dense(rng, WIDTH, D_LAT))),
        linear_rec=((), (_dense(rng, D_OBS, D_LAT),
                         _dense(rng, D_OBS, D_LAT))),
        linear_dec=((), (_dense(rng, D_LAT, D_OBS),
                         _dense(rng, D_LAT, D_OBS))))
    x = rng.standard_normal((4, 5, D_OBS))
    samples = rng.standard_normal((2, 4, 5, D_LAT))
    y = rng.standard_normal((4, 5, D_OBS))
    mask = (rng.random((4, 5)) > 0.3).astype(np.float64)

    def references(p, x, samples, y, mask):
        r32 = jax.tree.map(lambda a: a.astype(jnp.float32), p["resnet"])
        dec = p["linear_dec"]
        iso = jax_mlp.init_gaussian_mlp_isometric(
            jax.random.key(5), (D_LAT, WIDTH, D_OBS), dtype=jnp.float64)
        return dict(
            iso=(iso, jax_decoders.mlp_decode(iso, samples)),
            resnet=jax_recognition.resnet_recognize(p["resnet"], x),
            resnet_bf16=jax_recognition.resnet_recognize(
                r32, x.astype(jnp.float32), compute_dtype=jnp.bfloat16),
            linear_rec=jax_recognition.linear_recognize(p["linear_rec"], x),
            linear_dec=jax_decoders.linear_decode(dec, samples,
                                                  mean_fn=jax.nn.sigmoid),
            loglike=(jax_decoders.linear_loglike(dec, samples, y),
                     jax_decoders.linear_loglike(dec, samples, y,
                                                 mask=mask)))

    args = (p, x, samples, y, mask)
    ref = jax.jit(references).lower(*args).compile()(*args)
    t = torch.from_numpy
    return dict(params=p, x=t(x), samples=t(samples), y=t(y), mask=t(mask),
                ref=ref)


def test_recognizers_match_jax(nets):
    """The residual recognizer (float64; and its bf16 path in float32,
    which the float32 path misses by more than TOL_BF16) and the linear
    recognizer, converted from the JAX package's parameters."""
    p, x, ref = nets["params"], nets["x"], nets["ref"]
    net = convert.resnet_recognizer(p["resnet"], dtype=torch.float64,
                                    device="cpu")
    _close(recognition.resnet_recognize(net, x), ref["resnet"])
    net32 = convert.resnet_recognizer(p["resnet"], dtype=torch.float32,
                                      device="cpu")
    got = recognition.resnet_recognize(net32, x.float(), torch.bfloat16)
    assert all(g.dtype == torch.float32 for g in got)
    _close(got, ref["resnet_bf16"], TOL_BF16)
    f32 = recognition.resnet_recognize(net32, x.float())[1]
    assert not np.allclose(f32.detach().numpy(),
                           np.asarray(ref["resnet_bf16"][1]), **TOL_BF16)
    net = convert.linear_recognizer(p["linear_rec"], dtype=torch.float64,
                                    device="cpu")
    _close(recognition.linear_recognize(net, x), ref["linear_rec"])


def test_linear_decoder_and_loglike_match_jax(nets):
    """linear_decode (with a mean_fn) and the MC-averaged linear_loglike
    (S samples, batch and time axes, with and without a mask) against the
    JAX package's."""
    net = convert.linear_decoder(nets["params"]["linear_dec"],
                                 dtype=torch.float64, device="cpu")
    s, ref = nets["samples"], nets["ref"]
    _close(decoders.linear_decode(net, s, mean_fn=torch.sigmoid),
           ref["linear_dec"])
    for masked in (False, True):
        got = decoders.linear_loglike(net, s, nets["y"],
                                      mask=nets["mask"] if masked else None)
        _close([got], [ref["loglike"][int(masked)]])


def test_isometric_init_matches_jax(nets):
    """rand_partial_isometry has orthonormal columns (rows when wide);
    init_gaussian_mlp_isometric's decoder has that mean map, a zero
    log-variance map with bias sigma_init and the JAX package's parameter
    shapes; and the JAX package's isometric decoder, converted, decodes as
    it does."""
    g = torch.Generator().manual_seed(4)
    for m, n in ((8, 5), (3, 7)):
        Q = mlp.rand_partial_isometry(m, n, g, torch.float64, "cpu")
        G = Q.T @ Q if m >= n else Q @ Q.T
        torch.testing.assert_close(G, torch.eye(min(m, n),
                                                dtype=torch.float64))
    dec = mlp.init_gaussian_mlp_isometric((D_LAT, WIDTH, D_OBS), g,
                                          sigma_init=-3.0,
                                          dtype=torch.float64, device="cpu")
    W = dec.head.mean_layer.W
    torch.testing.assert_close(W.T @ W, torch.eye(D_OBS,
                                                  dtype=torch.float64))
    assert bool((dec.head.sig_layer.W == 0).all())
    assert bool((dec.head.sig_layer.b == -3.0).all())
    params, want = nets["ref"]["iso"]
    assert ([tuple(p.shape) for p in dec.parameters()]
            == [a.shape for a in jax.tree.leaves(params)])
    net = convert.decoder(jax.tree.map(np.asarray, params),
                          dtype=torch.float64, device="cpu")
    _close(decoders.mlp_decode(net, nets["samples"]), want)


INITS = {
    "init_resnet": lambda g, **kw: mlp.init_resnet(D_OBS, WIDTH, DEPTH, g,
                                                   **kw),
    "rand_partial_isometry": lambda g, **kw: mlp.rand_partial_isometry(
        D_OBS, D_LAT, g, **kw),
    "init_gaussian_mlp_isometric":
        lambda g, **kw: mlp.init_gaussian_mlp_isometric(
            (D_LAT, WIDTH, D_OBS), g, **kw),
    "init_resnet_recognize": lambda g, **kw: recognition.init_resnet_recognize(
        D_OBS, WIDTH, DEPTH, D_LAT, g, **kw),
    "init_linear_recognize": lambda g, **kw: recognition.init_linear_recognize(
        D_OBS, D_LAT, g, **kw),
    "init_linear_decode": lambda g, **kw: decoders.init_linear_decode(
        D_LAT, D_OBS, g, **kw),
    "resnet_recognizer": lambda g, **kw: convert.resnet_recognizer(
        (((np.ones((D_OBS, WIDTH)), np.zeros(WIDTH)), ()),
         ((np.ones((WIDTH, D_LAT)), np.zeros(D_LAT)),) * 2), **kw),
}


def _devices(made):
    if isinstance(made, torch.nn.Module):
        return {p.device.type for p in made.parameters()}
    return {made.device.type}


def test_new_inits_default_to_the_card():
    """Each new entry point places its tensors on "cuda" unless asked for
    the CPU, even from a CPU generator, which raises where there is no
    card."""
    g = torch.Generator().manual_seed(0)
    for name, init in sorted(INITS.items()):
        assert _devices(init(g, device="cpu")) == {"cpu"}, name
        if torch.cuda.is_available():
            assert _devices(init(g)) == {"cuda"}, name
        else:
            with pytest.raises((RuntimeError, AssertionError),
                               match="CUDA"):
                init(g)
