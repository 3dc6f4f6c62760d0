"""Parity of the port's conv recognizer and decoder options
(svae_tpu_torch/nets/recognition.py ``conv_recognize``,
``make_conv_recognize``; nets/decoders.py ``make_mlp_loglike``,
``compute_dtype=``) with the JAX package, on the CPU; the conv-LDS model
built on them is tests/test_torch_conv_lds.py's.

In float64 every value and gradient is held at rtol 1e-8 / atol 1e-10:
``conv_recognize`` at frames (8, 8) and (7, 9) (odd, so SAME padding at
stride 2 is asymmetric: the JAX package's ``_conv2d_im2col`` pads 0 rows
before an even frame and 1 after it) with channels (4,) and (4, 8), its
gradients with respect to every weight and the data; ``make_mlp_loglike``
likewise. The bfloat16 path (products of bf16-rounded operands, a float32
result) is held to the JAX package's bf16 path at the tier TOL_BF16
below, and shown to differ from the float32 path by more than that. The
JAX references are one XLA program compiled once in a module fixture,
without XLA's backend optimizations (they cost a third of the compile and
change no float64 value compared here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svae_tpu.nets import decoders as jax_decoders
from svae_tpu.nets import recognition as jax_recognition

from svae_tpu_torch import convert
from svae_tpu_torch.nets import decoders, recognition
from svae_tpu_torch.utils.pytree import tree_leaves

torch.set_num_threads(1)
F64 = dict(dtype=torch.float64, device="cpu")
TOL = dict(rtol=1e-8, atol=1e-10)
# the bf16 path against the JAX package's bf16 path, both float32 on the
# CPU: each side rounds the same float32 operands to bf16 and sums exact
# products in float32, in its own order, so the results differ by float32
# rounding, which a later layer's bf16 rounding can turn into one bf16 ulp
# (2^-8 relative) of an activation
TOL_BF16 = dict(rtol=2e-3, atol=2e-3)
CONV_CASES = {"8x8_c4": ((8, 8), (4,)), "7x9_c48": ((7, 9), (4, 8))}
BATCH = (2, 3)  # leading axes of the conv inputs: B, T


def _conv_params(rng, hw, channels, d, k=3, scale=0.5):
    """JAX-layout conv recognizer parameters with random float64 values
    (the biases too, which the init leaves at zero)."""
    convs, c_in = [], 1
    for c_out in channels:
        convs.append((scale * rng.standard_normal((k, k, c_in, c_out)),
                      0.1 * rng.standard_normal(c_out)))
        c_in = c_out
    h, w = hw
    for _ in channels:
        h, w = (h + 1) // 2, (w + 1) // 2
    layer = lambda: (0.3 * rng.standard_normal((h * w * c_in, d)),
                     0.1 * rng.standard_normal(d))
    return tuple(convs), (layer(), layer())


def _mlp_params(rng, sizes):
    layer = lambda m, n: (0.5 * rng.standard_normal((m, n)),
                          0.1 * rng.standard_normal(n))
    return (tuple(layer(m, n) for m, n in zip(sizes[:-2], sizes[1:-1])),
            (layer(*sizes[-2:]), layer(*sizes[-2:])))


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def refs():
    rng = np.random.default_rng(17)
    d, d_obs, H = 3, 5, 6
    inputs = {}
    for name, (hw, ch) in CONV_CASES.items():
        inputs[name] = dict(
            params=_conv_params(rng, hw, ch, d),
            data=rng.standard_normal(BATCH + (hw[0] * hw[1],)),
            cot=(rng.standard_normal(BATCH + (d,)),
                 rng.standard_normal(BATCH + (d,))))
    inputs["loglike"] = dict(
        params=_mlp_params(rng, (d, H, d_obs)),
        samples=rng.standard_normal((2,) + BATCH + (d,)),
        y=rng.standard_normal(BATCH + (d_obs,)),
        mask=(rng.random(BATCH) > 0.3).astype(np.float64))
    bf = dict(conv=_f32(inputs["7x9_c48"]),
              loglike=_f32(inputs["loglike"]))

    def references(inputs, bf):
        out = {}
        for name, (hw, _) in CONV_CASES.items():
            x = inputs[name]
            val, vjp = jax.vjp(lambda p, dd: jax_recognition.conv_recognize(
                p, dd, hw), x["params"], x["data"])
            out[name] = dict(value=val, grad=vjp(x["cot"]))
        x = inputs["loglike"]
        loglike = jax_decoders.make_mlp_loglike()
        f = lambda p, s, yy: loglike(p, s, yy, mask=x["mask"])
        out["loglike"] = dict(value=f(x["params"], x["samples"], x["y"]),
                              grad=jax.grad(f, argnums=(0, 1, 2))(
                                  x["params"], x["samples"], x["y"]))
        # the bf16 paths, float32
        b = bf["conv"]
        out["bf16_conv"] = jax_recognition.make_conv_recognize(
            CONV_CASES["7x9_c48"][0], compute_dtype=jnp.bfloat16)(
                b["params"], b["data"])
        b = bf["loglike"]
        out["bf16_loglike"] = jax_decoders.make_mlp_loglike(
            compute_dtype=jnp.bfloat16)(b["params"], b["samples"], b["y"],
                                        mask=b["mask"])
        return out

    out = jax.tree.map(np.asarray, jax.jit(references).lower(
        inputs, bf).compile({"xla_backend_optimization_level": 0})(
            inputs, bf))
    return dict(out, inputs=inputs, bf=bf)


def _close(port, ref, tol=TOL):
    port_leaves, ref_leaves = tree_leaves(port), jax.tree.leaves(ref)
    assert len(port_leaves) == len(ref_leaves)
    for p, r in zip(port_leaves, ref_leaves):
        np.testing.assert_allclose(torch.as_tensor(p).detach().numpy(),
                                   np.asarray(r), **tol)


def _t(a, grad=False, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype, requires_grad=grad)


def _conv_grads(net):
    """The conv recognizer's parameter gradients in the JAX layout."""
    out = []
    for conv in net.convs:
        out.append((conv.W.grad.permute(2, 3, 1, 0), conv.b.grad))
    head = net.head
    return (tuple(out), ((head.j_layer.W.grad, head.j_layer.b.grad),
                         (head.h_layer.W.grad, head.h_layer.b.grad)))


@pytest.mark.parametrize("name", list(CONV_CASES))
def test_conv_recognize_matches_jax(refs, name):
    hw, _ = CONV_CASES[name]
    x = refs["inputs"][name]
    net = convert.conv_recognizer(x["params"], **F64)
    data = _t(x["data"], grad=True)
    J, h = recognition.make_conv_recognize(hw)(net, data)
    _close((J, h), refs[name]["value"])
    assert J.shape == BATCH + (3,) and bool((J > 0).all())
    ((J * _t(x["cot"][0])).sum() + (h * _t(x["cot"][1])).sum()).backward()
    _close((_conv_grads(net), data.grad), refs[name]["grad"])


def test_conv_padding_is_the_jax_packages():
    """At H=16, k=3, stride 2: 0 rows before the frame and 1 after, which
    ``conv2d(padding=1)`` would not give."""
    x = torch.zeros((1, 1, 16, 16), dtype=torch.float64)
    x[0, 0, 0, 0] = 1.0  # only the first pixel is set
    W = torch.zeros((1, 1, 3, 3), dtype=torch.float64)
    W[0, 0, 0, 0] = 1.0  # the kernel's first tap
    with torch.no_grad():
        out = recognition.ConvSame(W, torch.zeros(1, dtype=torch.float64))(x)
    assert out.shape == (1, 1, 8, 8)
    # with no padding before the frame, output (0, 0)'s first tap is pixel
    # (0, 0)
    assert float(out[0, 0, 0, 0]) == 1.0 and float(out.abs().sum()) == 1.0


def test_make_mlp_loglike_matches_jax(refs):
    x = refs["inputs"]["loglike"]
    net = convert.decoder(x["params"], **F64)
    samples, y = _t(x["samples"], grad=True), _t(x["y"], grad=True)
    val = decoders.make_mlp_loglike()(net, samples, y,
                                      mask=_t(x["mask"]))
    _close(val, refs["loglike"]["value"])
    val.backward()
    grads = (tuple((l.W.grad, l.b.grad) for l in net.hidden.layers),
             ((net.head.mean_layer.W.grad, net.head.mean_layer.b.grad),
              (net.head.sig_layer.W.grad, net.head.sig_layer.b.grad)))
    _close((grads, samples.grad, y.grad), refs["loglike"]["grad"])


def test_bf16_paths_match_jax_bf16(refs):
    """The bf16 conv recognizer and decoder against the JAX package's bf16
    paths at TOL_BF16; the float32 path is farther from them than that,
    so the comparison sees the rounding."""
    b = refs["bf"]["conv"]
    hw = CONV_CASES["7x9_c48"][0]
    net = convert.conv_recognizer(b["params"], dtype=torch.float32,
                                  device="cpu")
    data = _t(b["data"], dtype=torch.float32)
    got = recognition.make_conv_recognize(hw, torch.bfloat16)(net, data)
    assert all(g.dtype == torch.float32 for g in got)
    _close(got, refs["bf16_conv"], TOL_BF16)
    f32 = recognition.make_conv_recognize(hw)(net, data)
    gap = max(float((np.abs(a.detach().numpy() - r)
                     / (TOL_BF16["atol"] + TOL_BF16["rtol"] * np.abs(r)))
                    .max()) for a, r in zip(f32, refs["bf16_conv"]))
    assert gap > 1.0

    b = refs["bf"]["loglike"]
    dec = convert.decoder(b["params"], dtype=torch.float32, device="cpu")
    args = (_t(b["samples"], dtype=torch.float32),
            _t(b["y"], dtype=torch.float32))
    got = decoders.make_mlp_loglike(compute_dtype=torch.bfloat16)(
        dec, *args, mask=_t(b["mask"], dtype=torch.float32))
    assert got.dtype == torch.float32
    _close(got, refs["bf16_loglike"], TOL_BF16)
