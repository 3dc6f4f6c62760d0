"""Experiment configs: a copy of svae_tpu/config.py for the port.

One dataclass per experiment family and the named presets of
BASELINE.json's ``configs[]``, with the JAX package's field names, defaults
and values, so that ``--preset x --train.field v`` means the same in both
packages. ``parse_config`` turns any dataclass into argparse flags
(``--field value``, ``--train.field value``); every example script is
``python -m svae_tpu_torch.examples.<name> [--preset name] [--field value
...] [--device cpu]``.
"""

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass
class TrainConfig:
    num_epochs: int = 50
    batch_size: int = 64
    num_samples: int = 2
    pgm_step_size: float = 0.5
    net_step_size: float = 1e-3
    net_optimizer: str = "adam"  # "adam" | "sga" | "adadelta" (optim.py)
    natgrad_scale: float = 1.0
    seed: int = 0
    metrics_every: int = 1  # callback/metrics cadence (one host sync each)
    # the callback cadence of loop.run and run_loader: with k > 1 the
    # callback fires at the end of a group of k steps in which a multiple
    # of metrics_every fell, as the JAX package's grouped dispatches do;
    # the trajectory does not depend on k. Checkpoint cadence rounds to
    # group boundaries accordingly.
    steps_per_dispatch: int = 1
    # accepted for the JAX package's flags; the port's eager loops own no
    # donated buffers, so it has no effect
    donate_groups: bool = True
    metrics_path: Optional[str] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 500
    # opt-in lossy dtype coercion on restore (e.g. resuming an f64-trained
    # checkpoint into an f32 template after a precision migration); the
    # default keeps checkpoint.restore's strict dtype check
    checkpoint_cast: bool = False
    profile_dir: Optional[str] = None
    debug_nans: bool = False
    plot_path: Optional[str] = None  # write a PNG summary after training
    animate_path: Optional[str] = None  # GIF of training snapshots (GMM)


@dataclass
class GMMConfig:
    # BASELINE config 1: GMM-SVAE on 2D pinwheel, MLP recognizer, K=8
    K: int = 8
    d_latent: int = 2
    num_classes: int = 5
    num_per_class: int = 200
    hidden: Tuple[int, ...] = (40,)
    meanfield_iters: int = 25
    train: TrainConfig = field(default_factory=TrainConfig)


@dataclass
class LDSConfig:
    # BASELINE config 2: LDS-SVAE on 1D dot videos, T=100
    T: int = 100
    d_latent: int = 10
    image_width: int = 20
    num_seqs: int = 512
    hidden: Tuple[int, ...] = (64,)
    # inference route: "auto" and "pallas" run the sequential E-step
    # kernels (the stationary ones for a batch of one length); "xla" runs
    # the parallel-in-time route that scan_chunks names (C > 0: the chunked
    # scan of ops/chunked.py; 0: the sequential kernels)
    backend: str = "auto"
    scan_chunks: int = 0
    train: TrainConfig = field(default_factory=lambda: TrainConfig(
        batch_size=32))


@dataclass
class MissingLDSConfig(LDSConfig):
    # Missing-data variant of config 2: a fraction of frames is dropped
    # (NaN-marked); trains through the masked-evidence pipeline
    # (data/masking.py, models/lds.run_inference(mask=)) and reports
    # smoother-imputation error at the dropped frames.
    missing_frac: float = 0.25


@dataclass
class RaggedLDSConfig(LDSConfig):
    # Variable-length corpus: T becomes the MAX length; sequences are
    # drawn with lengths in [T_min, T], trained through the
    # length-bucketed loader (data/loader.py) with exact lengths=
    # ragged-batch semantics. pad_multiple bounds the compile count.
    T_min: int = 20
    pad_multiple: int = 16


@dataclass
class SLDSConfig:
    # BASELINE config 3: switching LDS, HMM x Kalman structured mean-field
    K: int = 4
    T: int = 80
    d_latent: int = 4
    image_width: int = 16
    num_seqs: int = 256
    hidden: Tuple[int, ...] = (64,)
    meanfield_iters: int = 12
    backend: str = "auto"  # see LDSConfig.backend
    train: TrainConfig = field(default_factory=lambda: TrainConfig(
        batch_size=16))


@dataclass
class ConvLDSConfig:
    # BASELINE config 4: high-dim image sequences, conv recognizer, T=500
    T: int = 500
    d_latent: int = 16
    frame_hw: Tuple[int, int] = (16, 16)
    channels: Tuple[int, ...] = (16, 32)
    kernel_size: int = 3
    num_seqs: int = 128
    hidden_dec: Tuple[int, ...] = (128,)
    backend: str = "auto"   # see LDSConfig.backend
    # scan_chunks is read only by backend="xla", the chunked route; "auto"
    # and "pallas" run the stationary E-step kernels and ignore it
    scan_chunks: int = 64
    # "bfloat16" runs the conv and decoder products on bfloat16 operands
    # with a float32 result; the PGM algebra stays float32
    net_compute_dtype: str = "float32"
    train: TrainConfig = field(default_factory=lambda: TrainConfig(
        batch_size=8))


@dataclass
class BigDataDPConfig:
    # BASELINE config 5: large-corpus data-parallel natural-gradient SVI
    T: int = 50
    d_latent: int = 8
    image_width: int = 16
    num_seqs: int = 100_000
    hidden: Tuple[int, ...] = (64,)
    data_parallel: Optional[int] = None  # None = all devices
    mc_parallel: int = 1
    train: TrainConfig = field(default_factory=lambda: TrainConfig(
        batch_size=256))


PRESETS = {
    "gmm_pinwheel": GMMConfig(),
    "lds_dots": LDSConfig(),
    "slds_synth": SLDSConfig(),
    "conv_lds": ConvLDSConfig(),
    "bigdata_dp": BigDataDPConfig(),
    # small variants for the tests and a quick run
    "gmm_pinwheel_smoke": GMMConfig(
        K=6, num_per_class=20,
        train=TrainConfig(num_epochs=3, batch_size=50)),
    "lds_dots_smoke": LDSConfig(
        T=30, d_latent=4, num_seqs=32,
        train=TrainConfig(num_epochs=2, batch_size=8)),
    "lds_missing": MissingLDSConfig(),
    "lds_missing_smoke": MissingLDSConfig(
        T=30, d_latent=4, num_seqs=32, missing_frac=0.3,
        train=TrainConfig(num_epochs=2, batch_size=8)),
    "lds_ragged": RaggedLDSConfig(),
    "lds_ragged_smoke": RaggedLDSConfig(
        T=24, T_min=6, d_latent=4, num_seqs=24, pad_multiple=8,
        # steps_per_dispatch=2 exercises the grouped loader path
        # (group_by_shape loader + run_loader's group cadence) end to end
        train=TrainConfig(num_epochs=2, batch_size=8,
                          steps_per_dispatch=2)),
    "slds_synth_smoke": SLDSConfig(
        K=3, T=20, d_latent=3, num_seqs=16,
        train=TrainConfig(num_epochs=1, batch_size=4)),
    "conv_lds_smoke": ConvLDSConfig(
        T=20, d_latent=4, frame_hw=(8, 8), channels=(4,), num_seqs=8,
        train=TrainConfig(num_epochs=1, batch_size=4)),
    "bigdata_dp_smoke": BigDataDPConfig(
        T=10, d_latent=3, num_seqs=256,
        train=TrainConfig(num_epochs=1, batch_size=64)),
}


def _add_fields(parser, cfg, prefix=""):
    for f in dataclasses.fields(cfg):
        val = getattr(cfg, f.name)
        name = f"--{prefix}{f.name}"
        dest = f"{prefix}{f.name}".replace(".", "_")
        if dataclasses.is_dataclass(val):
            _add_fields(parser, val, prefix=f"{f.name}.")
        elif isinstance(val, bool):
            parser.add_argument(name, dest=dest, type=lambda s: s.lower() in
                                ("1", "true", "yes"), default=None)
        elif isinstance(val, tuple):
            parser.add_argument(name, dest=dest, type=lambda s: tuple(
                int(x) for x in s.split(",")), default=None)
        else:
            typ = type(val) if val is not None else str
            parser.add_argument(name, dest=dest, type=typ, default=None)


def _apply_overrides(cfg, args, prefix=""):
    updates = {}
    for f in dataclasses.fields(cfg):
        val = getattr(cfg, f.name)
        key = f"{prefix}{f.name}".replace(".", "_")
        if dataclasses.is_dataclass(val):
            updates[f.name] = _apply_overrides(val, args,
                                               prefix=f"{f.name}.")
        else:
            ov = getattr(args, key, None)
            if ov is not None:
                updates[f.name] = ov
    return dataclasses.replace(cfg, **updates)


def parse_config(default_preset, argv=None, presets=PRESETS):
    """Parse ``[--preset name] [--field value ...]`` into a config."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--preset", default=default_preset)
    known, rest = pre.parse_known_args(argv)
    cfg = presets[known.preset]
    parser = argparse.ArgumentParser(parents=[pre])
    _add_fields(parser, cfg)
    args = parser.parse_args(argv)
    return _apply_overrides(cfg, args)
