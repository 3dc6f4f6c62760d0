"""Structured per-step metrics (port of svae_tpu/train/metrics.py).

``MetricsWriter`` appends JSONL records (``step``, ``time``, then the
values); ``StepTimer`` measures fenced step time: it synchronizes the card
before reading the clock when a tensor it is given lies there, so the
number is the step's latency, not the time to issue it.
"""

import json
import time

import torch


class MetricsWriter:
    def __init__(self, path=None):
        self.path = path
        self._f = open(path, "a") if path else None

    def write(self, step, **values):
        rec = {"step": int(step), "time": time.time(), **values}
        if self._f is not None:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        return rec

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None


class StepTimer:
    """Fenced wall-clock timing of device computations."""

    def __init__(self):
        self.last = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, *tensors):
        for t in tensors:
            if isinstance(t, torch.Tensor) and t.is_cuda:
                torch.cuda.synchronize(t.device)
        self.last = time.perf_counter() - self._t0
        return self.last
