"""Parameters of the JAX package -> the port's objects.

The JAX package's parameters are pytrees; convert them to NumPy first
(``jax.tree.map(np.asarray, params)``) and pass the NumPy trees here, so
this module needs no JAX:

* a PGM natural parameter (nested tuples of arrays) -> the same nesting
  of tensors;
* an MLP recognizer ``(hidden ((W, b), ...), ((Wj, bj), (Wh, bh)))`` ->
  :class:`~svae_tpu_torch.nets.recognition.MLPRecognizer`;
* an MLP decoder ``(hidden, ((Wm, bm), (Ws, bs)))`` ->
  :class:`~svae_tpu_torch.nets.decoders.MLPDecoder`.

Dense weights keep their (n_in, n_out) layout (svae_tpu_torch/nets/mlp.py).
Like the ``init_*`` entry points, each function places its tensors on the
card unless given ``device="cpu"``.
"""

import numpy as np
import torch

from svae_tpu_torch.nets.decoders import MLPDecoder
from svae_tpu_torch.nets.mlp import (Dense, GaussianInfoHead,
                                     GaussianMeanHead, MLP)
from svae_tpu_torch.nets.recognition import MLPRecognizer
from svae_tpu_torch.utils.pytree import tree_map


def _tensor(a, dtype, device):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def natparam(tree, dtype=None, device="cuda"):
    """Nested tuples of arrays -> nested tuples of tensors."""
    return tree_map(lambda a: _tensor(a, dtype, device), tree)


def _dense(pair, dtype, device):
    W, b = pair
    return Dense(_tensor(W, dtype, device), _tensor(b, dtype, device))


def _hidden(params, dtype, device):
    return MLP([_dense(p, dtype, device) for p in params])


def recognizer(params, dtype=None, device="cuda"):
    hidden, (j_layer, h_layer) = params
    return MLPRecognizer(
        _hidden(hidden, dtype, device),
        GaussianInfoHead(_dense(j_layer, dtype, device),
                         _dense(h_layer, dtype, device)))


def decoder(params, dtype=None, device="cuda"):
    hidden, (mean_layer, sig_layer) = params
    return MLPDecoder(
        _hidden(hidden, dtype, device),
        GaussianMeanHead(_dense(mean_layer, dtype, device),
                         _dense(sig_layer, dtype, device)))
