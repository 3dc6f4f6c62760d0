"""Serving-side helpers of the online filters (port of
svae_tpu/models/streaming.py).

``lds.make_online_filter`` and ``slds.make_online_filter`` return the same
``(init_fn, step_fn)`` contract: one frame's diagonal recognition
potentials in, the filtered posterior and the frame's predictive
log-evidence out. This module serves a window of W frames a call, and
replays a stored sequence, through that contract.

A window is a loop of ``step_fn`` over its frames, so its outputs are
those of W single-frame calls bit for bit; it saves the caller W - 1
round trips, not device work. The frames of a window lie on the axis
after the streams' leading axes: potentials (..., W, d), outputs (..., W)
+ the per-frame output's own axes.
"""

import torch


def _frames(state, step_fn, potentials, start, outs):
    """``step_fn`` over the frames ``start``.. of ``potentials`` (..., W,
    d) from ``state``, appending each frame's outputs to ``outs``; returns
    the last state and the outputs stacked on the window axis."""
    nb = potentials[0].dim() - 2
    for w in range(start, potentials[0].shape[nb]):
        state, out = step_fn(state, tuple(x.select(nb, w)
                                          for x in potentials))
        outs.append(out)
    return state, tuple(torch.stack(o, nb) for o in zip(*outs))


def make_window_filter(init_fn, step_fn):
    """Wrap an online filter into window-at-a-time calls. Returns
    ``(window_init_fn, window_step_fn)``::

      state, outs = window_init_fn((J_diag, h))          # frames 1..W
      state, outs = window_step_fn(state, (J_diag, h))   # the next W

    with ``(J_diag, h)`` (..., W, d) each. ``outs`` holds the wrapped
    filter's per-frame outputs with a window axis W after the leading
    axes (means (..., W, d), covariances (..., W, d, d), log-evidence
    (..., W)); ``state`` is the filter's state after the window's last
    frame, so windows chain: T/W windows give the states and outputs of T
    single-frame calls, bit for bit."""

    def window_init_fn(potentials):
        nb = potentials[0].dim() - 2
        state, out0 = init_fn(tuple(x.select(nb, 0) for x in potentials))
        return _frames(state, step_fn, potentials, 1, [out0])

    def window_step_fn(state, potentials):
        return _frames(state, step_fn, potentials, 0, [])

    return window_init_fn, window_step_fn


def replay(init_fn, step_fn, potentials):
    """A stored sequence through an online filter: ``outs =
    replay(init_fn, step_fn, (J_diag, h))`` with (..., T, d) inputs gives
    the per-frame outputs stacked on the frame axis (the window filter at
    W = T), for offline scoring or segmentation of recorded streams with
    the streaming semantics."""
    window_init_fn, _ = make_window_filter(init_fn, step_fn)
    return window_init_fn(potentials)[1]
