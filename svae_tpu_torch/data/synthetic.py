"""Synthetic data: NumPy copies of svae_tpu/data/synthetic.py's
``make_pinwheel``, ``make_dot_data``, ``rand_lds`` and ``lds_rollout``, of
examples/slds_synth.py's ``make_switching_dot_data`` and of
examples/conv_lds.py's ``make_2d_dot_movies``, giving the same arrays for
the same seed (tested)."""

import numpy as np


def make_pinwheel(seed=0, num_classes=5, num_per_class=100, radial_std=0.3,
                  tangential_std=0.05, rate=0.25):
    """2-D pinwheel: ``num_classes`` spiral arms of ``num_per_class``
    points each, shuffled; float32 (num_classes * num_per_class, 2). The
    GMM-SVAE's dataset."""
    rng = np.random.RandomState(seed)
    rads = np.linspace(0, 2 * np.pi, num_classes, endpoint=False)
    features = rng.randn(num_classes * num_per_class, 2) * np.array(
        [radial_std, tangential_std])
    features[:, 0] += 1.0
    labels = np.repeat(np.arange(num_classes), num_per_class)
    angles = rads[labels] + rate * np.exp(features[:, 0])
    rotations = np.stack(
        [np.cos(angles), -np.sin(angles), np.sin(angles), np.cos(angles)],
        axis=-1).reshape(-1, 2, 2)
    data = np.einsum("ni,nij->nj", features, rotations)
    perm = rng.permutation(len(data))
    return data[perm].astype(np.float32)


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


def rand_lds(seed=0, d=2, eigmax=0.9, q_scale=0.1):
    """A random stable LDS ``(A, Q, mu0, S0)``: A with spectral radius
    ``eigmax``, Q = q_scale I, mu0 = 0, S0 = I (float64)."""
    rng = np.random.RandomState(seed)
    A = rng.randn(d, d)
    A *= eigmax / max(np.abs(np.linalg.eigvals(A)))
    return A, q_scale * np.eye(d), np.zeros(d), np.eye(d)


def lds_rollout(A, Q, mu0, S0, T, seed=0, num_seqs=1):
    """Trajectories x_{1:T} drawn from the LDS prior; float32
    (num_seqs, T, d)."""
    rng = np.random.RandomState(seed)
    d = A.shape[0]
    Lq = np.linalg.cholesky(Q)
    L0 = np.linalg.cholesky(S0)
    xs = np.empty((num_seqs, T, d))
    x = mu0 + rng.randn(num_seqs, d) @ L0.T
    for t in range(T):
        xs[:, t] = x
        x = x @ A.T + rng.randn(num_seqs, d) @ Lq.T
    return xs.astype(np.float32)


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


def make_2d_dot_movies(seed, num_seqs, T, hw):
    """A Gaussian blob bouncing around a 2D frame of ``hw`` = (H, W)
    pixels; float32 (num_seqs, T, H * W), frames flattened. The conv-LDS
    dataset (BASELINE config 4)."""
    rng = np.random.RandomState(seed)
    H, W = hw
    ys, xs = np.mgrid[0:H, 0:W]
    out = np.empty((num_seqs, T, H * W), np.float32)
    for s in range(num_seqs):
        p = rng.uniform([1, 1], [H - 2, W - 2])
        v = 0.4 * rng.randn(2)
        for t in range(T):
            img = np.exp(-0.5 * (((ys - p[0]) ** 2 + (xs - p[1]) ** 2)
                                 / 1.5 ** 2))
            out[s, t] = img.ravel()
            p = p + v
            for i, lim in enumerate((H - 1, W - 1)):
                if p[i] < 0 or p[i] > lim:
                    v[i] = -v[i]
                    p[i] = np.clip(p[i], 0, lim)
    out += 0.03 * rng.randn(*out.shape)
    return out.astype(np.float32)
