"""Parity of the port's training step (svae_tpu_torch/train/) with the JAX
package's, in float64 on the CPU.

One SVI step of the port (``make_gradfun``, ``make_train_step``) is held to
the JAX package's ``make_gradfun`` and jitted ``make_train_step`` on the
same parameters (carried over by svae_tpu_torch/convert.py), data and
noise. The JAX side's ``run_inference`` composes the packed E-step with
its Pallas kernels in interpret mode, so its gradient runs the adjoint
kernels ``_filter_adj_kernel`` and ``_sampler_adj_kernel``; it takes its
noise through the ``key`` argument, so the same NumPy noise reaches both
packages. Tolerance rtol 1e-8 / atol 1e-10 (both sides float64), for the
updated parameters too: Adam's first step moves a parameter by
lr * g / (|g| + eps), whose error is at most lr times the gradient's
relative error (the division by sqrt(v-hat) = |g| cancels the gradient's
scale), so it needs no looser tolerance than the gradient.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svae_tpu.data import synthetic as jax_synthetic
from svae_tpu.expfam import mniw as jax_mniw
from svae_tpu.expfam import niw as jax_niw
from svae_tpu.models import lds as jax_lds
from svae_tpu.nets import decoders as jax_decoders
from svae_tpu.nets import recognition as jax_recognition
from svae_tpu.ops import pallas_estep
from svae_tpu.train import elbo as jax_elbo
from svae_tpu.train import loop as jax_loop
from svae_tpu.train import optim as jax_optim

from svae_tpu_torch import convert
from svae_tpu_torch.models import lds
from svae_tpu_torch.nets import decoders, recognition
from svae_tpu_torch.train import elbo, loop, optim
from svae_tpu_torch.utils.pytree import tree_leaves

torch.set_num_threads(1)
RTOL, ATOL = 1e-8, 1e-10
B, T, d, S, D_OBS, N = 4, 8, 3, 2, 6, 40
LR = 1e-2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(port, ref):
    port_leaves, ref_leaves = tree_leaves(port), jax.tree.leaves(ref)
    assert len(port_leaves) == len(ref_leaves)
    for p, r in zip(port_leaves, ref_leaves):
        np.testing.assert_allclose(torch.as_tensor(p).detach().numpy(),
                                   np.asarray(r), rtol=RTOL, atol=ATOL)


def _jax_run_inference(prior, glob, pots, key, num_samples):
    """lds.run_inference(backend="pallas") spelled out, with the Pallas
    kernels in interpret mode and ``key`` carrying the noise itself."""
    (I1, I2), Ic = jax_niw.expected_gaussian_natparam(glob[0])
    mats = jax_mniw.expected_pair_potential(glob[1])
    samples, stats, local_kl = pallas_estep.lds_estep_stationary(
        (I1, I2, Ic), mats, pots, None, num_samples, block_b=8,
        interpret=True, eps=key)
    return samples, stats, jax_lds.prior_kl(glob, prior), local_kl


JAX_PARTS = (_jax_run_inference, jax_recognition.mlp_recognize,
             jax_decoders.mlp_loglike)


@pytest.fixture(scope="module")
def jax_model():
    k = jax.random.split(jax.random.key(7), 4)
    prior = jax_lds.init_pgm_param(k[0], d, dtype=jnp.float64)
    glob = jax_lds.init_pgm_param(k[1], d, dtype=jnp.float64)
    rp = jax_recognition.init_mlp_recognize(k[2], D_OBS, (8,), d,
                                            dtype=jnp.float64)
    dp = jax_decoders.init_mlp_decode(k[3], d, (8,), D_OBS,
                                      dtype=jnp.float64)
    y = jax_synthetic.make_dot_data(seed=2, num_seqs=B, T=T,
                                    image_width=D_OBS).astype(np.float64)
    eps = np.random.default_rng(5).standard_normal((S, B, T, d))
    gradfun = jax_elbo.make_gradfun(*JAX_PARTS, prior, N, num_samples=S)
    grad_out = jax.jit(gradfun)(glob, (rp, dp), jnp.asarray(y),
                                jnp.asarray(eps))
    return dict(prior=prior, glob=glob, nets=(rp, dp), y=y, eps=eps,
                grad_out=grad_out, steps={})


def _jax_step(jax_model, name):
    """The JAX package's jitted train step with net optimizer ``name``
    (cached per name)."""
    if name not in jax_model["steps"]:
        m = jax_model
        init, step = jax_loop.make_train_step(
            *JAX_PARTS, m["prior"], N, num_samples=S, net_optimizer=name,
            net_step_size=LR, donate=False)
        state = init(m["glob"], m["nets"])
        m["steps"][name] = step(m["glob"], m["nets"], state,
                                jnp.asarray(m["y"]), jnp.asarray(m["eps"]))
    return jax_model["steps"][name]


def _port(jax_model):
    """The JAX model's parameters, data and noise as the port's objects."""
    f64 = dict(dtype=torch.float64, device="cpu")
    rp, dp = jax_model["nets"]
    nets = (convert.recognizer(_np(rp), **f64), convert.decoder(_np(dp),
                                                                **f64))
    parts = (functools.partial(lds.run_inference,
                               eps=torch.from_numpy(jax_model["eps"])),
             recognition.mlp_recognize, decoders.mlp_loglike,
             convert.natparam(_np(jax_model["prior"]), **f64), N)
    return (convert.natparam(_np(jax_model["glob"]), **f64), nets,
            torch.from_numpy(jax_model["y"]), parts)


def test_gradfun_matches_jax(jax_model):
    """ELBO, natural gradient, net gradients and terms of one step."""
    glob, nets, y, parts = _port(jax_model)
    gradfun = elbo.make_gradfun(*parts, num_samples=S)
    value, natgrad, net_grads, terms = gradfun(glob, nets, y, None)
    v_r, nat_r, grads_r, terms_r = jax_model["grad_out"]
    _close(value, v_r)
    _close(natgrad, nat_r)
    _close(net_grads, grads_r)
    assert sorted(terms) == sorted(terms_r)
    for k in terms_r:
        _close(terms[k], terms_r[k])
    # gradients are returned, not left in .grad
    assert all(p.grad is None for net in nets for p in net.parameters())


@pytest.mark.parametrize("name", ["adam", "sga"])
def test_train_step_matches_jax(jax_model, name):
    """Parameters after the natgrad + net-optimizer update, ELBO and
    terms, against the JAX package's jitted train step."""
    glob, nets, y, parts = _port(jax_model)
    init, step = loop.make_train_step(*parts, num_samples=S,
                                      net_optimizer=name, net_step_size=LR)
    state = init(glob, nets)
    pgm1, nets1, state1, value, terms = step(glob, nets, state, y, None)
    pgm_r, nets_r, _, value_r, terms_r = _jax_step(jax_model, name)
    assert state1.step == 1
    _close(value, value_r)
    _close(pgm1, pgm_r)
    _close(elbo.net_parameters(nets1), nets_r)
    for k in terms_r:
        _close(terms[k], terms_r[k])


@pytest.mark.parametrize("name", ["adam", "sga", "adadelta"])
def test_net_optimizer_matches_optax(name):
    """Three updates of the port's net optimizer against the JAX package's
    (optax) on the same ascent gradients; the PGM globals take plain
    ascent along the natural gradient."""
    rng = np.random.default_rng(3)
    W, b = rng.standard_normal((3, 2)), rng.standard_normal(2)
    pgm = (rng.standard_normal((2, 2)),)
    grads = [(rng.standard_normal((3, 2)), rng.standard_normal(2))
             for _ in range(3)]
    nat = (rng.standard_normal((2, 2)),)
    init_j, update_j = jax_optim.make_optimizer(name, 0.5, 0.1)
    net_j, pgm_j = ((W, b),), pgm
    st_j = init_j(pgm_j, net_j)
    module = torch.nn.Module()
    module.W = torch.nn.Parameter(torch.from_numpy(W))
    module.b = torch.nn.Parameter(torch.from_numpy(b))
    init_p, update_p = optim.make_optimizer(name, 0.5, 0.1)
    net_p, pgm_p = (module,), (torch.from_numpy(pgm[0]),)
    st_p = init_p(pgm_p, net_p)
    for g in grads:
        pgm_j, net_j, st_j = update_j(st_j, pgm_j, net_j, nat, (g,))
        pgm_p, net_p, st_p = update_p(
            st_p, pgm_p, net_p, (torch.from_numpy(nat[0]),),
            (tuple(torch.from_numpy(x) for x in g),))
        _close(pgm_p, pgm_j)
        _close(elbo.net_parameters(net_p), net_j)
    assert st_p.step == 3 and int(st_j.step) == 3


def test_unknown_net_optimizer_raises():
    with pytest.raises(ValueError, match="adadelta"):
        optim.make_optimizer("rmsprop")


def _tiny(seed=0):
    """A small float64 model of the port on the CPU."""
    g = torch.Generator().manual_seed(seed)
    kw = dict(dtype=torch.float64, device="cpu")
    prior = lds.init_pgm_param(d, g, **kw)
    glob = lds.init_pgm_param(d, g, **kw)
    rec = recognition.init_mlp_recognize(D_OBS, (8,), d, g, **kw)
    dec = decoders.init_mlp_decode(d, (8,), D_OBS, g, **kw)
    data = torch.from_numpy(jax_synthetic.make_dot_data(
        seed=seed, num_seqs=3 * B, T=T, image_width=D_OBS)).double()
    parts = (lds.run_inference, recognition.mlp_recognize,
             decoders.mlp_loglike, prior, N)
    return glob, (rec, dec), data, parts


def test_fused_step_equals_single_steps():
    """make_fused_train_step(k=3, stacked_batch=True) is exactly three
    make_train_step calls drawing from the same generator state."""
    glob, nets, data, parts = _tiny()
    batches = data.reshape(3, B, T, D_OBS)
    init, fused = loop.make_fused_train_step(*parts, k_steps=3,
                                             num_samples=S,
                                             stacked_batch=True)
    nets_a = copy.deepcopy(nets)
    pgm_a, nets_a, st_a, value_a, terms_a, elbos_a = fused(
        glob, nets_a, init(glob, nets_a), batches,
        torch.Generator().manual_seed(9))
    init1, step = loop.make_train_step(*parts, num_samples=S)
    pgm_b, nets_b = glob, copy.deepcopy(nets)
    st_b = init1(pgm_b, nets_b)
    gen = torch.Generator().manual_seed(9)
    elbos_b = []
    for batch in batches:
        pgm_b, nets_b, st_b, value_b, terms_b = step(pgm_b, nets_b, st_b,
                                                     batch, gen)
        elbos_b.append(value_b)
    exact = functools.partial(torch.testing.assert_close, rtol=0, atol=0)
    exact(elbos_a, torch.stack(elbos_b))
    exact(value_a, value_b)
    for a, b in zip(tree_leaves(pgm_a), tree_leaves(pgm_b)):
        exact(a, b)
    for a, b in zip(tree_leaves(elbo.net_parameters(nets_a)),
                    tree_leaves(elbo.net_parameters(nets_b))):
        exact(a, b)
    for k in terms_b:
        exact(terms_a[k], terms_b[k])
    assert st_a.step == st_b.step == 3
    with pytest.raises(ValueError, match="3 batches"):
        fused(glob, nets_a, st_a, batches[:2], gen)


def test_run_callback_cadence_matches_jax():
    """loop.run fires its callback every ``callback_every`` steps and on
    the last, as the JAX package's run does, and returns the ELBO history
    of every step."""
    glob, nets, data, parts = _tiny(1)
    init, step = loop.make_train_step(*parts, num_samples=S)
    fired = []
    _, _, state, history, _ = loop.run(
        step, glob, nets, init(glob, nets), data[:4 * 2],
        torch.Generator().manual_seed(0), num_epochs=2, batch_size=2,
        callback_every=3,
        callback=lambda i, e, params, terms, gen: fired.append(
            (i, e, sorted(terms))))

    fired_j = []
    fake_step = lambda p, n, s, b, k: (p, n, s, jnp.sum(b), {"x": 0.0})
    jax_loop.run(fake_step, (), (), (), jnp.ones((8, 2)), jax.random.key(0),
                 num_epochs=2, batch_size=2, callback_every=3,
                 callback=lambda i, *_: fired_j.append(i))
    assert [i for i, _, _ in fired] == fired_j == [2, 5, 7]
    assert len(history) == 8 and np.isfinite(history).all()
    assert [e for _, e, _ in fired] == [history[i] for i in fired_j]
    assert fired[0][2] == ["global_kl", "local_kl", "loglike",
                           "net_grad_norm"]
    assert state.step == 8
