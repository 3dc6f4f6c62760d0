"""Missing-data helpers (port of svae_tpu/data/masking.py).

A frame is missing when any of its observation dims is non-finite; the
pipeline (recognition potentials, chain inference, decoder
log-likelihood) drops it through multiplicative {0,1} masks, so every
kernel keeps its shape. See models/lds.run_inference(mask=, lengths=) and
train/elbo.make_objective(mask_fn=, ragged=).
"""

import numpy as np
import torch


def nan_mask(batch):
    """``batch (..., T, d_obs)`` with NaN/inf marking missing frames ->
    ``(clean_batch, mask)``: ``mask (..., T)`` is 1.0 for fully finite
    frames and ``clean_batch`` has zeros in place of the non-finite entries.
    Use as ``make_objective(mask_fn=...)``."""
    finite = torch.isfinite(batch)
    mask = finite.all(-1).to(batch.dtype)
    clean = torch.where(finite, batch, torch.zeros((), dtype=batch.dtype,
                                                   device=batch.device))
    return clean, mask


def pad_batch(sequences, T=None, dtype=None):
    """Host-side: a list of (T_i, d) arrays -> ``(batch (B, T, d), lengths
    (B,))`` as NumPy arrays, zero-padded to the longest (or the given) T.
    Feed ``lengths`` to ``run_inference`` for exact ragged-batch training."""
    Tmax = T if T is not None else max(int(s.shape[0]) for s in sequences)
    d = sequences[0].shape[-1]
    out = np.zeros((len(sequences), Tmax, d),
                   dtype or np.asarray(sequences[0]).dtype)
    lengths = np.zeros((len(sequences),), np.int32)
    for i, s in enumerate(sequences):
        t = int(s.shape[0])
        if t > Tmax:
            raise ValueError(f"sequence {i} longer ({t}) than T={Tmax}")
        out[i, :t] = np.asarray(s)
        lengths[i] = t
    return out, lengths
