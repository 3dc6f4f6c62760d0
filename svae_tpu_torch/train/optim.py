"""Optimizers: natural-gradient ascent for the conjugate PGM globals, a
``torch.optim`` optimizer for the nets (port of svae_tpu/train/optim.py).

The JAX version is pure: it returns new parameters and a new optimizer
state. Here the nets are ``nn.Module``s updated in place by their
``torch.optim`` optimizer, whose moment buffers are keyed to the
``Parameter`` objects: a copy per step would cost a second set of
parameters and buffers on the card and gain nothing, since the caller
rebinds the returned nets anyway. The PGM globals, plain tensors, are
returned as new tensors as in the JAX version.
"""

from dataclasses import dataclass

import torch

from svae_tpu_torch.train.elbo import net_parameters
from svae_tpu_torch.utils.pytree import tree_add, tree_scale

# optax's defaults: adam(b1=0.9, b2=0.999, eps=1e-8), sgd without momentum,
# adadelta(rho=0.9, eps=1e-6); maximize=True makes each take the ELBO's
# ascent gradients as they are (optax is handed their negation)
_NET_OPTIMIZERS = {
    "adam": lambda params, lr: torch.optim.Adam(
        params, lr=lr, betas=(0.9, 0.999), eps=1e-8, maximize=True),
    "sga": lambda params, lr: torch.optim.SGD(params, lr=lr, maximize=True),
    "adadelta": lambda params, lr: torch.optim.Adadelta(
        params, lr=lr, rho=0.9, eps=1e-6, maximize=True),
}


@dataclass
class SVAEOptState:
    """The nets' torch optimizer and the number of updates taken."""
    net_optimizer: torch.optim.Optimizer
    step: int = 0


def get_net_optimizer(name):
    """The net-optimizer preset ``name`` ("adam", "sga" or "adadelta"), as
    ``make(params, step_size) -> torch.optim.Optimizer``."""
    if name not in _NET_OPTIMIZERS:
        raise ValueError(f"unknown net optimizer {name!r}; one of "
                         f"{sorted(_NET_OPTIMIZERS)}")
    return _NET_OPTIMIZERS[name]


def make_optimizer(net_optimizer=None, pgm_step_size=1.0,
                   net_step_size=1e-3):
    """Returns ``(init, update)``:

      init(pgm_params, net_params) -> SVAEOptState
      update(state, pgm_params, net_params, pgm_natgrad, net_grads)
          -> (new_pgm_params, net_params, state)

    PGM globals: plain ascent along the natural gradient,
    ``params + pgm_step_size * natgrad``. Nets: ``net_optimizer`` is a
    preset name (default "adam") or ``make(params, step_size)``; it ascends
    on ``net_grads`` (congruent with ``elbo.net_parameters``) and updates
    the nets in place."""
    if net_optimizer is None:
        net_optimizer = "adam"
    make = (get_net_optimizer(net_optimizer)
            if isinstance(net_optimizer, str) else net_optimizer)

    def init(pgm_params, net_params):
        params = [p for ps in net_parameters(net_params) for p in ps]
        return SVAEOptState(make(params, net_step_size))

    def update(state, pgm_params, net_params, pgm_natgrad, net_grads):
        new_pgm = tree_add(pgm_params, tree_scale(pgm_natgrad, pgm_step_size))
        for ps, gs in zip(net_parameters(net_params), net_grads):
            for p, g in zip(ps, gs):
                p.grad = g
        state.net_optimizer.step()
        state.net_optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return new_pgm, net_params, state

    return init, update
