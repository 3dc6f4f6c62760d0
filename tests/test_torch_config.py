"""The port's config copy (svae_tpu_torch/config.py) against the JAX
package's svae_tpu/config.py: the same dataclasses with the same field
names and defaults, the same presets field by field, and ``parse_config``
giving the same config for the same command line."""

import dataclasses

import pytest

from svae_tpu import config as jax_config

from svae_tpu_torch import config

CLASSES = ("TrainConfig", "GMMConfig", "LDSConfig", "MissingLDSConfig",
           "RaggedLDSConfig", "SLDSConfig", "ConvLDSConfig",
           "BigDataDPConfig")


@pytest.mark.parametrize("name", CLASSES)
def test_dataclasses_match(name):
    ours, ref = getattr(config, name), getattr(jax_config, name)
    assert ([f.name for f in dataclasses.fields(ours)]
            == [f.name for f in dataclasses.fields(ref)])
    assert dataclasses.asdict(ours()) == dataclasses.asdict(ref())


def test_presets_match_field_by_field():
    assert list(config.PRESETS) == list(jax_config.PRESETS)
    for name, cfg in config.PRESETS.items():
        ref = jax_config.PRESETS[name]
        assert type(cfg).__name__ == type(ref).__name__, name
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref), name


@pytest.mark.parametrize("preset, argv", [
    ("lds_dots", []),
    ("lds_dots", ["--preset", "lds_dots_smoke", "--T", "12"]),
    ("conv_lds", ["--frame_hw", "7,9", "--channels", "4,8",
                  "--net_compute_dtype", "bfloat16"]),
    ("conv_lds", ["--preset", "conv_lds_smoke", "--train.batch_size", "2",
                  "--train.net_step_size", "0.01",
                  "--train.donate_groups", "false",
                  "--train.checkpoint_cast", "true",
                  "--train.metrics_path", "m.jsonl"]),
    ("gmm_pinwheel", ["--preset", "gmm_pinwheel_smoke", "--K", "3",
                      "--hidden", "16,8", "--train.num_epochs", "5"]),
    ("slds_synth", ["--backend", "xla", "--train.steps_per_dispatch", "4"]),
    ("lds_ragged", ["--preset", "lds_ragged_smoke", "--T_min", "3"]),
])
def test_parse_config_matches(preset, argv):
    ours = config.parse_config(preset, argv)
    ref = jax_config.parse_config(preset, argv)
    assert type(ours).__name__ == type(ref).__name__
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    # the overrides took effect, in both
    if "--train.batch_size" in argv:
        assert ours.train.batch_size == 2
    if "--channels" in argv:
        assert ours.channels == (4, 8)
