"""The port's checkpoints (svae_tpu_torch/train/checkpoint.py) in the JAX
package's npz format: the committed fixtures restore, every mismatch the
JAX package's tests check raises (tests/test_train.py), a checkpoint of
plain containers moves between the two packages in both directions with
the same paths and leaves, and a whole training state (nets, Adam, the
generator, the counter) round-trips so that training continues bitwise.
No JAX program is compiled."""

import collections
import copy
import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svae_tpu.train import checkpoint as jax_ckpt

from svae_tpu_torch.data.synthetic import make_dot_data
from svae_tpu_torch.models import lds
from svae_tpu_torch.nets import decoders, recognition
from svae_tpu_torch.train import checkpoint as ckpt
from svae_tpu_torch.train import loop
from svae_tpu_torch.train.optim import SVAEOptState

torch.set_num_threads(1)
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
NT = collections.namedtuple("NT", ["x", "y"])


def _fixture_like(pgm_shape=(2, 3)):
    return {"pgm": (torch.zeros(pgm_shape),), "net": [torch.zeros(4)],
            "step": torch.tensor(0, dtype=torch.int32)}


@pytest.mark.parametrize("name", ["ckpt_fixture_v2.npz",
                                  "ckpt_fixture_v1.npz"])
def test_committed_fixtures_restore(name):
    """Stored paths net/0, pgm/0, step: the sorted dict keys, as the JAX
    package wrote them."""
    state = ckpt.restore(os.path.join(FIXTURES, name), _fixture_like())
    assert int(state["step"]) == 7 and state["step"].dtype == torch.int32
    np.testing.assert_array_equal(state["pgm"][0].numpy(),
                                  np.arange(6, dtype=np.float32).reshape(2, 3))
    np.testing.assert_array_equal(state["net"][0].numpy(), 2.5)
    assert isinstance(state["pgm"], tuple) and isinstance(state["net"], list)
    with pytest.raises(ValueError):
        ckpt.restore(os.path.join(FIXTURES, name), _fixture_like((3, 3)))


def test_structure_mismatch_raises(tmp_path):
    path = str(tmp_path / "c.npz")
    ckpt.save(path, {"a": torch.zeros(3)})
    with pytest.raises(ValueError):
        ckpt.restore(path, {"b": torch.zeros(3)})  # renamed key
    with pytest.raises(ValueError):
        ckpt.restore(path, {"a": torch.zeros(4)})  # wrong shape
    with pytest.raises(ValueError):
        ckpt.restore(path, {"a": torch.zeros(3), "c": torch.zeros(1)})
    assert ckpt.latest(str(tmp_path), prefix="c") is None


def test_dtype_mismatch_raises_unless_cast(tmp_path):
    path = str(tmp_path / "c.npz")
    ckpt.save(path, {"a": torch.zeros(3, dtype=torch.float64)})
    with pytest.raises(ValueError, match="dtype"):
        ckpt.restore(path, {"a": torch.zeros(3)})
    out = ckpt.restore(path, {"a": torch.zeros(3)}, cast=True)
    assert out["a"].dtype == torch.float32
    out = ckpt.restore(path, {"a": torch.zeros(3, dtype=torch.float64)})
    assert out["a"].dtype == torch.float64


def test_latest(tmp_path):
    assert ckpt.latest(str(tmp_path / "missing")) is None
    for name in ("ckpt_3.npz", "ckpt_12.npz", "ckpt_x.npz", "other_40.npz",
                 "ckpt_epoch_2.npz", "ckpt_7.npz.tmp"):
        (tmp_path / name).write_bytes(b"")
    assert ckpt.latest(str(tmp_path)).endswith("ckpt_12.npz")
    assert ckpt.latest(str(tmp_path),
                       prefix="ckpt_epoch_").endswith("ckpt_epoch_2.npz")


def _plain_state(rng, lib):
    """One state of plain containers: ``lib`` makes the arrays (torch
    tensors for the port, jnp arrays for the JAX package)."""
    a = lambda *s: lib(rng.standard_normal(s))
    return {"pgm": ((a(2, 2), a(2)), [a(3), a(1, 4)]),
            "od": collections.OrderedDict([("z", a(2)), ("b", a(3))]),
            "nt": NT(a(1), None), "step": np.asarray(5, np.int64),
            "b_key": lib(np.arange(3, dtype=np.int32))}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_plain_containers_cross_packages(tmp_path, writer):
    """The same state written by either package has the same fingerprint
    (paths, shapes, dtypes) and leaves, and restores under the other's
    template."""
    ours = _plain_state(np.random.default_rng(3), torch.from_numpy)
    ref = _plain_state(np.random.default_rng(3), jnp.asarray)
    p_port, p_jax = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    ckpt.save(p_port, ours)
    jax_ckpt.save(p_jax, ref)
    with np.load(p_port) as a, np.load(p_jax) as b:
        assert json.loads(bytes(a["__structure__"])) == \
            json.loads(bytes(b["__structure__"]))
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    src = p_port if writer == "port" else p_jax
    got_jax = jax_ckpt.restore(src, ref)
    got_port = ckpt.restore(src, ours)
    assert isinstance(got_port["od"], collections.OrderedDict)
    assert isinstance(got_port["nt"], NT) and got_port["nt"].y is None
    assert isinstance(got_port["pgm"][1], list)
    flat_port = [leaf for _, leaf in ckpt._flatten(got_port)]
    flat_jax = [leaf for _, leaf in ckpt._flatten(got_jax)]
    assert len(flat_port) == len(flat_jax) == 9
    for p, r in zip(flat_port, flat_jax):
        np.testing.assert_array_equal(np.asarray(p), np.asarray(r))


def _training(seed=0):
    """A small LDS-SVAE training setup on the CPU, in float32."""
    g = torch.Generator().manual_seed(seed)
    d, d_obs, B, T = 3, 6, 4, 9
    kw = dict(device="cpu")
    prior = lds.init_pgm_param(d, g, **kw)
    glob = lds.init_pgm_param(d, g, **kw)
    nets = (recognition.init_mlp_recognize(d_obs, (8,), d, g, **kw),
            decoders.init_mlp_decode(d, (8,), d_obs, g, **kw))
    data = torch.from_numpy(make_dot_data(seed=1, num_seqs=3 * B, T=T,
                                          image_width=d_obs))
    opt_init, step = loop.make_train_step(
        lds.run_inference, recognition.mlp_recognize, decoders.mlp_loglike,
        prior, data.shape[0], num_samples=2, net_step_size=1e-2)
    return glob, nets, opt_init, step, data[:B]


def _steps(step, state, batch, gen, n):
    pgm, nets, st = state
    elbos = []
    for _ in range(n):
        pgm, nets, st, elbo, _ = step(pgm, nets, st, batch, gen)
        elbos.append(float(elbo))
    return (pgm, nets, st), elbos


def test_training_state_round_trips_and_continues_bitwise(tmp_path):
    """(pgm, nets, opt_state, generator, step) after two steps, restored
    into a fresh template (Adam without state yet, another generator
    state, other weights) on the CPU: the next steps equal those of the
    uninterrupted run bit for bit."""
    glob, nets, opt_init, step, batch = _training()
    gen = torch.Generator().manual_seed(5)
    state, _ = _steps(step, (glob, nets, opt_init(glob, nets)), batch, gen, 2)
    path = str(tmp_path / "ckpt_2.npz")
    ckpt.save(path, state + (gen, np.asarray(2, np.int64)))
    saved = copy.deepcopy(state)
    _, want = _steps(step, state, batch, gen, 3)

    glob2, nets2, _, _, _ = _training(seed=1)
    template = (glob2, nets2, opt_init(glob2, nets2),
                torch.Generator().manual_seed(99), np.zeros((), np.int64))
    pgm, nets_r, st, gen_r, count = ckpt.restore(path, template)
    assert nets_r[0] is nets2[0] and st.net_optimizer is \
        template[2].net_optimizer and gen_r is template[3]
    assert isinstance(st, SVAEOptState) and st.step == 2 and int(count) == 2
    for a, b in zip(tuple(pgm) + tuple(nets_r),
                    tuple(saved[0]) + tuple(saved[1])):
        for x, y in zip(ckpt._flatten(a), ckpt._flatten(b)):
            assert torch.equal(x[1], y[1])
    adam = st.net_optimizer.state_dict()["state"]
    assert adam[0]["step"].dtype == torch.float32 and \
        float(adam[0]["step"]) == 2.0
    _, got = _steps(step, (pgm, nets_r, st), batch, gen_r, 3)
    assert got == want
    # the template's dtype check passes on a template made by the same code
    ckpt.restore(path, template)


def test_optimizer_template_without_state_is_not_stepped():
    """Reading a fresh optimizer's layout takes a step of a copy, never of
    the optimizer itself."""
    glob, nets, opt_init, _, _ = _training()
    st = opt_init(glob, nets)
    before = [p.detach().clone() for n in nets for p in n.parameters()]
    flat = ckpt._flatten(st)
    assert [p[-1] for p, _ in flat][:3] == ["exp_avg", "exp_avg_sq", "step"]
    assert st.net_optimizer.state_dict()["state"] == {}
    for p, q in zip((p for n in nets for p in n.parameters()), before):
        assert torch.equal(p.detach(), q)
