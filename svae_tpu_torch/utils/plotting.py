"""Plotting helpers for the example experiments: a copy of
svae_tpu/utils/plotting.py for the port (static PNG and GIF writers,
headless-safe). All imports are lazy so the core library never depends on
matplotlib. Arrays may be NumPy arrays or tensors on any device."""

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _np(a):
    """A tensor (any device) or array as a NumPy array."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def _gmm_moments(global_natparam):
    import torch

    from svae_tpu_torch.expfam import dirichlet, gaussian, niw
    from svae_tpu_torch.utils.pytree import tree_map

    dir_np, niw_np = tree_map(
        lambda a: torch.as_tensor(_np(a), dtype=torch.float64),
        global_natparam)
    (E1, E2), _ = niw.expected_gaussian_natparam(niw_np)
    mu, Sigma = (_np(a) for a in gaussian.natural_to_standard((E1, E2)))
    weights = np.exp(_np(dirichlet.expectedstats(dir_np)))
    return mu, Sigma, weights / weights.sum()


def _draw_gmm(ax, data, mu, Sigma, weights):
    data = _np(data)
    ax.scatter(data[:, 0], data[:, 1], s=4, alpha=0.4, c="gray")
    t = np.linspace(0, 2 * np.pi, 64)
    circ = np.stack([np.cos(t), np.sin(t)])
    for k in range(mu.shape[0]):
        if weights[k] < 1e-3:
            continue
        L = np.linalg.cholesky(Sigma[k])
        e = mu[k][:, None] + 2.0 * L @ circ
        ax.plot(e[0], e[1], lw=1.5)
        ax.scatter(*mu[k], marker="x")


def plot_gmm_clusters(path, data, global_natparam, recogn_latents=None):
    """Scatter the 2D data colored by most-likely cluster plus 2-sigma
    ellipses of each cluster's expected Gaussian (the README-gif view)."""
    plt = _plt()
    mu, Sigma, weights = _gmm_moments(global_natparam)
    fig, ax = plt.subplots(figsize=(5, 5))
    _draw_gmm(ax, data, mu, Sigma, weights)
    ax.set_title("GMM-SVAE latent clusters")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def animate_gmm_clusters(path, snapshots, fps=4):
    """Training animation: one frame per snapshot ``(latents, natparam,
    step)`` -- the reference's live matplotlib animation (the README gif;
    reference: experiments/gmm_svae_synth.py callback) written as a GIF
    after training instead of during it (headless-safe)."""
    from matplotlib.animation import PillowWriter

    plt = _plt()
    fig, ax = plt.subplots(figsize=(5, 5))
    writer = PillowWriter(fps=fps)
    with writer.saving(fig, path, dpi=90):
        for latents, natparam, step in snapshots:
            ax.clear()
            mu, Sigma, weights = _gmm_moments(natparam)
            _draw_gmm(ax, latents, mu, Sigma, weights)
            ax.set_title(f"GMM-SVAE latent clusters (step {step})")
            writer.grab_frame()
    plt.close(fig)


def plot_elbo(path, history):
    plt = _plt()
    fig, ax = plt.subplots(figsize=(5, 3))
    ax.plot(_np(history))
    ax.set_xlabel("step")
    ax.set_ylabel("ELBO / datapoint")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_lds_reconstruction(path, seq_true, seq_pred):
    """Side-by-side imshow of a true vs reconstructed image sequence
    (T, width) -- the dots-experiment view."""
    plt = _plt()
    fig, axes = plt.subplots(1, 2, figsize=(8, 3))
    for ax, img, title in zip(axes, (seq_true, seq_pred),
                              ("data", "reconstruction")):
        ax.imshow(_np(img).T, aspect="auto", origin="lower",
                  cmap="viridis")
        ax.set_title(title)
        ax.set_xlabel("t")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_slds_segmentation(path, pred_paths, true_paths=None):
    """Discrete-state segmentation strips: one row per sequence, color =
    MAP state (``models/slds.most_likely_states``); optionally a second
    panel with the true regimes (reference: the SLDS experiments'
    state-sequence figures)."""
    plt = _plt()
    pred = _np(pred_paths)
    n = 2 if true_paths is not None else 1
    fig, axes = plt.subplots(n, 1, figsize=(7, 1.2 * n + 1.2),
                             squeeze=False)
    axes[0][0].imshow(pred, aspect="auto", interpolation="nearest",
                      cmap="tab10")
    axes[0][0].set_title("MAP discrete states (Viterbi)")
    axes[0][0].set_ylabel("sequence")
    if true_paths is not None:
        axes[1][0].imshow(_np(true_paths), aspect="auto",
                          interpolation="nearest", cmap="tab10")
        axes[1][0].set_title("true regimes")
        axes[1][0].set_ylabel("sequence")
        axes[1][0].set_xlabel("t")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_frame_montage(path, frames_true, frames_pred, hw, num_frames=10):
    """Two-row montage of 2D frames (true on top, reconstruction below),
    evenly subsampled in time -- the conv-LDS experiment view. ``frames_*``
    are (T, H*W); ``hw`` = (H, W)."""
    plt = _plt()
    H, W = hw
    T = frames_true.shape[0]
    idx = np.linspace(0, T - 1, num_frames).astype(int)
    fig, axes = plt.subplots(2, num_frames,
                             figsize=(1.1 * num_frames, 2.6))
    for col, t in enumerate(idx):
        for row, fr in enumerate((frames_true, frames_pred)):
            ax = axes[row][col]
            ax.imshow(_np(fr[t]).reshape(H, W), cmap="gray_r",
                      interpolation="nearest")
            ax.set_xticks([]); ax.set_yticks([])
            if row == 0:
                ax.set_title(f"t={t}", fontsize=7)
    axes[0][0].set_ylabel("true", fontsize=8)
    axes[1][0].set_ylabel("recon", fontsize=8)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
