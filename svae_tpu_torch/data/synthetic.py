"""Synthetic data: NumPy copies of svae_tpu/data/synthetic.py's
``make_dot_data`` and of examples/slds_synth.py's
``make_switching_dot_data``, giving the same arrays for the same seed
(tested)."""

import numpy as np


def make_dot_data(seed=0, num_seqs=64, T=100, image_width=20, dot_width=3,
                  v=0.3, noise_std=0.05):
    """1D bouncing-dot image sequences: a dot of ``dot_width`` pixels moves
    at velocity ``v`` px/frame and reflects off the walls; each frame is a
    1D image row (width ``image_width``). Returns float32
    (num_seqs, T, image_width)."""
    rng = np.random.RandomState(seed)
    xs = np.arange(image_width)
    out = np.empty((num_seqs, T, image_width), np.float32)
    span = image_width - dot_width
    for s in range(num_seqs):
        pos = rng.uniform(0, span)
        vel = v * rng.choice([-1.0, 1.0])
        for t in range(T):
            # triangle-wave reflection keeps pos in [0, span]
            p = np.abs(((pos + span) % (2 * span)) - span)
            center = p + 0.5 * (dot_width - 1)
            out[s, t] = np.exp(-0.5 * ((xs - center) / (dot_width / 2.0)) ** 2)
            pos += vel
    out += noise_std * rng.randn(*out.shape)
    return out.astype(np.float32)


def make_switching_dot_data(seed, num_seqs, T, image_width,
                            return_states=False):
    """Dot sequences whose velocity regime (0.1 or 0.6 px/frame) switches
    with probability 0.05 a frame, so the ground truth has switching
    linear dynamics. Returns float32 (num_seqs, T, image_width) and, with
    ``return_states``, the true regime paths, int32 (num_seqs, T)."""
    rng = np.random.RandomState(seed)
    xs = np.arange(image_width)
    out = np.empty((num_seqs, T, image_width), np.float32)
    states = np.empty((num_seqs, T), np.int32)
    speeds = [0.1, 0.6]
    for s in range(num_seqs):
        pos = rng.uniform(2, image_width - 2)
        regime = rng.randint(2)
        direction = rng.choice([-1.0, 1.0])
        for t in range(T):
            if rng.rand() < 0.05:
                regime = 1 - regime
            states[s, t] = regime
            pos += direction * speeds[regime]
            if pos < 1 or pos > image_width - 2:
                direction = -direction
                pos = np.clip(pos, 1, image_width - 2)
            out[s, t] = np.exp(-0.5 * ((xs - pos) / 1.5) ** 2)
    out += 0.05 * rng.randn(*out.shape)
    out = out.astype(np.float32)
    return (out, states) if return_states else out
