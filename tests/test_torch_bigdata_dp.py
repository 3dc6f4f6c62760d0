"""The port's BASELINE config 5 example (svae_tpu_torch/examples/
bigdata_dp.py) at its ``bigdata_dp_smoke`` preset on the CPU, in process:
launched without torchrun it forms a one-rank gloo group, trains through
the data-parallel step's collective, writes its metrics, checks the
replicas and takes its group down again. No JAX."""

import json

import numpy as np
import torch
import torch.distributed as dist

from svae_tpu_torch.config import PRESETS
from svae_tpu_torch.examples import bigdata_dp

torch.set_num_threads(1)


def test_bigdata_dp_smoke(tmp_path, capsys):
    mpath = tmp_path / "m.jsonl"
    hist = bigdata_dp.main(["--device", "cpu", "--preset",
                            "bigdata_dp_smoke", "--train.metrics_path",
                            str(mpath)])
    cfg = PRESETS["bigdata_dp_smoke"]
    steps = cfg.train.num_epochs * cfg.num_seqs // cfg.train.batch_size
    assert len(hist) == steps and np.isfinite(hist).all()
    assert not dist.is_initialized()
    records = [json.loads(line) for line in open(mpath)]
    assert [r["step"] for r in records] == list(range(steps))
    assert [r["elbo"] for r in records] == hist
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "mesh: {'mc': 1, 'data': 1} over 1 ranks (gloo)"
    assert out[-1].startswith(f"steps={steps} first_elbo=")
    assert "seqs/sec=" in out[-1]
