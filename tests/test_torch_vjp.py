"""Parity of the port's one-direction information filters
(``svae_tpu_torch.ops.bpairs.lds_filter`` and ``lds_backward``) with the
JAX package's differentiable ``pallas_vjp.lds_filter`` and
``pallas_vjp.lds_backward``, in float64 on the CPU.

The JAX functions run their Pallas kernels in interpret mode: the forward
filter ``_filter_fwd_kernel`` and the backward filter
``_backward_fwd_kernel``, and, for the gradients, their adjoints
``_filter_adj_kernel`` and ``_backward_adj_kernel``. The port runs
``bidir_fwd`` over one direction's B lanes, and its adjoint
``bidir_adj`` (on the CPU their plain versions). Values, and the gradients
of a random-weighted sum of every output with respect to the initial, pair
and node potentials, for pairs shared over the batch and per sequence, at
B=3, T=5, d=2 (B of block_b=8). Every JAX reference is compiled once, in a
module fixture. Tolerance rtol 1e-8 / atol 1e-10 (both sides float64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svae_tpu.ops import pallas_vjp

from svae_tpu_torch.ops import bpairs
from svae_tpu_torch.utils.pytree import tree_leaves
from tests.test_torch_kalman_fwd import chain

torch.set_num_threads(1)
RTOL, ATOL = 1e-8, 1e-10
B, T, d = 3, 5, 2
PAIRS = ["shared", "per_sequence"]


def _close(port, ref, rtol=RTOL, atol=ATOL):
    port_leaves, ref_leaves = tree_leaves(port), jax.tree.leaves(ref)
    assert len(port_leaves) == len(ref_leaves)
    for p, r in zip(port_leaves, ref_leaves):
        np.testing.assert_allclose(torch.as_tensor(p).detach().numpy(),
                                   np.asarray(r), rtol=rtol, atol=atol)


def _filter(lib, xs):
    init, pairs, nodes = xs[:3], xs[3:7], xs[7:]
    if lib is jnp:
        return pallas_vjp.lds_filter(init, pairs, nodes, block_b=8,
                                     interpret=True)
    return bpairs.lds_filter(init, pairs, nodes)


def _backward(lib, xs):
    pairs, nodes = xs[3:7], xs[7:]
    if lib is jnp:
        return pallas_vjp.lds_backward(pairs, nodes, block_b=8,
                                       interpret=True)
    return bpairs.lds_backward(pairs, nodes)


FNS = {"lds_filter": _filter, "lds_backward": _backward}


@pytest.fixture(scope="module")
def refs():
    """For each case: the leaves (init, pairs, nodes), the weights of the
    loss and the JAX function's outputs and gradients, all from one
    jit."""
    rng = np.random.default_rng(21)
    cases = {}
    for kind in PAIRS:
        init, pairs, nodes = chain(B, T, d, seed=3,
                                   per_sequence=kind == "per_sequence")
        leaves = tuple(init) + tuple(pairs) + tuple(nodes)
        for name in FNS:
            shapes = ([(B,), (B, T, d, d), (B, T, d)] if name == "lds_filter"
                      else [(B, T, d, d), (B, T, d)])
            cases[kind, name] = (leaves,
                                 [rng.standard_normal(s) for s in shapes])

    def loss(fn, lib, xs, weights):
        to = jnp.asarray if lib is jnp else torch.from_numpy
        return sum((to(w) * o).sum() for w, o in zip(weights, fn(lib, xs)))

    @jax.jit
    def ref(cases):
        return {k: (FNS[k[1]](jnp, xs), jax.grad(
            lambda ys: loss(FNS[k[1]], jnp, ys, ws))(xs))
            for k, (xs, ws) in cases.items()}

    return cases, ref(cases), loss


@pytest.mark.parametrize("kind", PAIRS)
@pytest.mark.parametrize("name", sorted(FNS))
def test_one_direction_filter_matches_pallas_vjp(refs, name, kind):
    cases, ref, loss = refs
    leaves, weights = cases[kind, name]
    ref_out, ref_grads = ref[kind, name]
    ins = [torch.as_tensor(np.asarray(x), dtype=torch.float64)
           .requires_grad_() for x in leaves]
    _close(FNS[name](torch, ins), ref_out)
    grads = torch.autograd.grad(loss(FNS[name], torch, ins, weights), ins,
                                allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(ins, grads)]
    _close(grads, ref_grads)


def test_one_direction_launches_take_b_lanes(refs):
    """Each filter runs bidir_fwd over its own direction's B lanes (not the
    2B of fb_pass) and agrees with fb_pass's half."""
    cases, _, _ = refs
    xs = [torch.as_tensor(np.asarray(x)) for x in cases["shared",
                                                      "lds_filter"][0]]
    init, pairs, nodes = xs[:3], xs[3:7], xs[7:]
    calls = bpairs.bidir_fwd_plain.calls
    logZ, Jf, hf = bpairs.lds_filter(init, pairs, nodes)
    Jb, hb = bpairs.lds_backward(pairs, nodes)
    assert bpairs.bidir_fwd_plain.calls == calls + 2
    _close((logZ, Jf, hf, Jb, hb),
           [x.numpy() for x in bpairs.fb_pass(init, pairs, nodes)])
    args = bpairs._packed(*bpairs._initial(init, nodes),
                          bpairs._streams(pairs, nodes))
    assert args[0].shape == (d * d, B) and args[2].shape == (T - 1, d * d, B)
