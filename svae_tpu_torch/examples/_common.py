"""What the example scripts share: the ``--device`` flag beside the
config's flags, the LDS examples' inference route, and the report line."""

import argparse

from svae_tpu_torch.config import parse_config


def parse(default_preset, argv=None):
    """``[--device cpu|cuda] [--preset name] [--field value ...]`` ->
    ``(config, device)``; the device defaults to the card."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    known, rest = pre.parse_known_args(argv)
    return parse_config(default_preset, rest), known.device


def lds_parallel(cfg):
    """``run_inference``'s ``parallel=`` for an LDS config's ``backend``:
    "auto" and "pallas" run the sequential E-step kernels (the stationary
    ones for a batch of one length), as the JAX package's "auto" does on
    its accelerator; "xla" runs the route ``scan_chunks`` names (C > 0:
    the chunked scan)."""
    if cfg.backend in ("auto", "pallas"):
        return False
    if cfg.backend == "xla":
        return cfg.scan_chunks or False
    raise ValueError(f"unknown backend {cfg.backend!r}; one of 'auto', "
                     f"'pallas', 'xla'")


def train_kwargs(tc):
    """``make_train_step``'s optimizer and sampling options from a
    ``TrainConfig``."""
    return dict(num_samples=tc.num_samples, natgrad_scale=tc.natgrad_scale,
                pgm_step_size=tc.pgm_step_size,
                net_step_size=tc.net_step_size,
                net_optimizer=tc.net_optimizer)


def report(hist):
    if hist:
        print(f"steps={len(hist)} first_elbo={hist[0]:.4f} "
              f"last_elbo={hist[-1]:.4f}")
    else:
        print("steps=0 (already at the target epoch count)")
