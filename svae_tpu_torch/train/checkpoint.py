"""Checkpoint / resume: save and restore the whole training state (port of
svae_tpu/train/checkpoint.py, in its file format).

The port's state is ``(pgm_params, net_params, opt_state, generator,
step)``: nested tuples of tensors, ``nn.Module``s, an
:class:`~svae_tpu_torch.train.optim.SVAEOptState` (a ``torch.optim``
optimizer and a step count), a ``torch.Generator`` and a counter. A resumed
run must reproduce the uninterrupted run's trajectory exactly.

Format, as the JAX package writes it: one ``np.savez`` archive of the
flattened leaves (``leaf_0``, ``leaf_1``, ...) and a versioned
``__structure__`` JSON fingerprint, each leaf's key path, shape and dtype
(v1 checkpoints carried a tag instead and get a shape-only check). No
pickle. Containers flatten in the JAX package's order, so a checkpoint of
plain containers written by either package restores in the other with the
same paths and leaves:

* a dict by its sorted keys (an ``OrderedDict`` in its own order); a
  tuple or list by position; a named tuple or dataclass by field; ``None``
  holds no leaf;
* an ``nn.Module`` as its ``state_dict()``, in its order (for the port's
  nets, the leaf order of the JAX package's parameter pytrees);
* a ``torch.optim`` optimizer as its per-parameter state, by parameter
  index and sorted state name (hyperparameters are the template's);
* a ``torch.Generator`` as one ``uint8`` leaf, its ``get_state()``.

Paths join the keys with ``/``, as the JAX package's ``_structure`` does.
"""

import collections
import dataclasses
import json
import os

import numpy as np
import torch
from torch import nn


FORMAT_VERSION = 2


def _probe_state(opt):
    """The per-parameter state a step of ``opt`` creates: torch optimizers
    fill their state at their first step, so a template made before any
    step has none. A copy of the optimizer over zero parameters takes one
    step with zero gradients to show its layout; ``opt`` is not touched."""
    groups, clones = [], []
    for g in opt.param_groups:
        ps = [torch.zeros_like(p, requires_grad=True) for p in g["params"]]
        for p in ps:
            p.grad = torch.zeros_like(p)
        clones += ps
        groups.append({**{k: v for k, v in g.items() if k != "params"},
                       "params": ps})
    probe = type(opt)(groups)
    probe.step()
    return probe.state_dict()["state"]


def _optimizer_state(opt):
    """``{parameter index: {state name: value}}`` of ``opt``."""
    state = opt.state_dict()["state"]
    n = sum(len(g["params"]) for g in opt.param_groups)
    if len(state) < n:
        state = {**_probe_state(opt), **state}
    return {i: dict(sorted(state[i].items())) for i in sorted(state)}


def _children(node):
    """``[(key, child), ...]`` of a container in the JAX package's flatten
    order, or None for a leaf."""
    if node is None:
        return []
    if isinstance(node, nn.Module):
        return list(node.state_dict().items())
    if isinstance(node, torch.optim.Optimizer):
        return list(_optimizer_state(node).items())
    if isinstance(node, dict):
        keys = (list(node) if isinstance(node, collections.OrderedDict)
                else sorted(node))
        return [(k, node[k]) for k in keys]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return list(enumerate(node))
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)]
    return None


def _flatten(node, path=()):
    """``[(path, leaf), ...]`` depth first."""
    kids = _children(node)
    if kids is None:
        return [(path, node)]
    return [x for k, c in kids for x in _flatten(c, path + (str(k),))]


def _array(leaf):
    """A leaf as the NumPy array it is stored as."""
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _structure(flat):
    """Versioned structural fingerprint: per-leaf key path + shape +
    dtype (the JAX package's, which never compares a repr)."""
    return {
        "version": FORMAT_VERSION,
        "leaves": [
            {"path": "/".join(p), "shape": list(a.shape),
             "dtype": a.dtype.name}
            for p, a in ((p, _array(l)) for p, l in flat)
        ],
    }


def save(path, state):
    """Serialize ``state`` to ``path`` (.npz)."""
    flat = _flatten(state)
    arrays = {f"leaf_{i}": _array(leaf) for i, (_, leaf) in enumerate(flat)}
    arrays["__structure__"] = np.frombuffer(
        json.dumps(_structure(flat)).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)  # atomic: a crash never leaves a torn checkpoint


def _leaf(new, like):
    """Stored array ``new`` (already in the template's dtype) as the kind
    of leaf ``like`` is, on its device."""
    if isinstance(like, torch.Generator):
        like.set_state(torch.from_numpy(np.array(new, np.uint8)))
        return like
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(new)).to(like.device)
    if isinstance(like, (np.ndarray, np.generic)):
        return np.asarray(new)
    return type(like)(new) if isinstance(like, (bool, int, float)) else new


def _rebuild(node, it):
    """``node``'s structure with its leaves taken in order from ``it``;
    modules, optimizers and generators are loaded in place."""
    kids = _children(node)
    if kids is None:
        return next(it)
    if node is None:
        return None
    vals = [(k, _rebuild(c, it)) for k, c in kids]
    if isinstance(node, nn.Module):
        node.load_state_dict(collections.OrderedDict(vals))
        return node
    if isinstance(node, torch.optim.Optimizer):
        sd = node.state_dict()
        sd["state"] = dict(vals)
        node.load_state_dict(sd)
        return node
    if isinstance(node, dict):
        return type(node)(vals)
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(v for _, v in vals))
    if isinstance(node, (tuple, list)):
        return type(node)(v for _, v in vals)
    return dataclasses.replace(node, **dict(vals))


def restore(path, like, cast=False):
    """Restore a state with the structure of ``like`` from ``path``: the
    same containers, tensors on the devices of ``like``'s, and its modules,
    optimizers and generators loaded in place.

    Raises ValueError if the stored leaf structure (count + paths + shapes
    + dtypes) does not match ``like``. A dtype mismatch (e.g. a float64
    checkpoint restored into a float32 template) raises unless
    ``cast=True`` is passed explicitly: the cast is lossy, so it must be
    opted into, never silent. v1 checkpoints (no fingerprint) get a
    shape-only check; they stored no dtypes."""
    flat = _flatten(like)
    leaves = [_array(l) for _, l in flat]
    with np.load(path) as data:
        n_stored = sum(1 for k in data.files if k.startswith("leaf_"))
        if n_stored != len(leaves):
            raise ValueError(
                f"checkpoint structure mismatch: {n_stored} stored leaves "
                f"vs {len(leaves)} expected")
        new_leaves = [data[f"leaf_{i}"] for i in range(len(leaves))]
        if "__structure__" in data.files:
            stored = json.loads(bytes(data["__structure__"]).decode())
            expected = _structure(flat)
            for i, (s, e) in enumerate(
                    zip(stored["leaves"], expected["leaves"])):
                if s["shape"] != e["shape"] or s.get("path", e["path"]) != \
                        e["path"]:
                    raise ValueError(
                        f"checkpoint structure mismatch at leaf {i}: "
                        f"stored {s.get('path')} shape {s['shape']} vs "
                        f"expected {e['path']} shape {e['shape']}")
                if not cast and s.get("dtype", e["dtype"]) != e["dtype"]:
                    raise ValueError(
                        f"checkpoint dtype mismatch at leaf {i} "
                        f"({e['path']}): stored {s['dtype']} vs expected "
                        f"{e['dtype']}; pass cast=True to coerce "
                        f"explicitly (lossy)")
        else:  # v1 checkpoint: structural check from the arrays themselves
            for i, (new, old) in enumerate(zip(new_leaves, leaves)):
                if tuple(new.shape) != tuple(old.shape):
                    raise ValueError(
                        f"checkpoint structure mismatch at leaf {i}: "
                        f"stored shape {tuple(new.shape)} vs expected "
                        f"{tuple(old.shape)}")
    it = iter(_leaf(np.asarray(new, dtype=old.dtype), l)
              for new, old, (_, l) in zip(new_leaves, leaves, flat))
    return _rebuild(like, it)


def latest(directory, prefix="ckpt_"):
    """Path of the highest-step checkpoint ``{prefix}{step}.npz`` in
    ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for name in os.listdir(directory):
        if name.startswith(prefix) and name.endswith(".npz"):
            try:
                step = int(name[len(prefix):-4])
            except ValueError:
                continue
            if step > best_step:
                best, best_step = os.path.join(directory, name), step
    return best
