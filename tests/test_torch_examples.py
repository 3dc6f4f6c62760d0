"""Every example script of the port (svae_tpu_torch/examples/) end to end
on the CPU at its ``*_smoke`` preset, in process, with the assertions of
tests/test_examples.py: finite ELBO histories, the GMM improving, the
ragged buckets' padded shapes, the missing-data RMSEs finite, the metrics
file written; and an epoch-granular resume through an example's command
line. No JAX."""

import json
import os

import numpy as np
import pytest
import torch

from svae_tpu_torch.examples import (conv_lds, gmm_pinwheel, lds_dots,
                                     lds_missing, lds_ragged, slds_synth)
from svae_tpu_torch.train import checkpoint as ckpt_lib

torch.set_num_threads(1)
CPU = ["--device", "cpu"]


def _check(hist):
    assert len(hist) > 0
    assert all(np.isfinite(hist))


def test_gmm_pinwheel_smoke(tmp_path):
    mpath = tmp_path / "m.jsonl"
    hist = gmm_pinwheel.main(CPU + ["--preset", "gmm_pinwheel_smoke",
                                    "--train.metrics_path", str(mpath)])
    _check(hist)
    assert np.mean(hist[-2:]) >= np.mean(hist[:2])
    lines = [json.loads(l) for l in open(mpath)]
    assert [l["step"] for l in lines] == list(range(len(hist)))


def test_lds_dots_smoke():
    _check(lds_dots.main(CPU + ["--preset", "lds_dots_smoke"]))


def test_lds_ragged_smoke():
    hist, shapes = lds_ragged.main(CPU + ["--preset", "lds_ragged_smoke"])
    _check(hist)
    # padded T's are multiples of pad_multiple, at most
    # ceil(T / pad_multiple) of them
    assert all(s % 8 == 0 for s in shapes)
    assert len(shapes) <= 3
    assert np.mean(hist[-3:]) >= np.mean(hist[:3])


def test_lds_missing_smoke():
    rmse, rmse_ffill = lds_missing.main(CPU + ["--preset",
                                               "lds_missing_smoke"])
    assert np.isfinite(rmse) and np.isfinite(rmse_ffill)


def test_slds_synth_smoke():
    _check(slds_synth.main(CPU + ["--preset", "slds_synth_smoke"]))


@pytest.mark.parametrize("extra", [[], ["--backend", "xla",
                                        "--net_compute_dtype", "bfloat16"]])
def test_conv_lds_smoke(extra):
    """The default route (the stationary E-step) and the chunked route of
    backend="xla" with the bf16 nets."""
    _check(conv_lds.main(CPU + ["--preset", "conv_lds_smoke"] + extra))


def test_checkpoint_resume_via_the_command_line(tmp_path):
    """Two epochs, then a resume toward four: the completed epochs are
    skipped, two more run from the saved state and the generator's
    stream, and together they are the uninterrupted four-epoch run."""
    argv = CPU + ["--preset", "lds_dots_smoke"]
    ckdir = str(tmp_path / "ck")
    hist1 = lds_dots.main(argv + ["--train.checkpoint_dir", ckdir])
    assert ckpt_lib.latest(ckdir).endswith("_8.npz")
    hist2 = lds_dots.main(argv + ["--train.checkpoint_dir", ckdir,
                                  "--train.num_epochs", "4"])
    assert ckpt_lib.latest(ckdir).endswith("_16.npz")
    full = lds_dots.main(argv + ["--train.num_epochs", "4"])
    assert hist1 + hist2 == full
    assert sorted(os.listdir(ckdir)) == ["ckpt_16.npz", "ckpt_8.npz"]
