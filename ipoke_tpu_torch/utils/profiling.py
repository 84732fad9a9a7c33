"""Tracing and per-step timing (counterpart of ``ipoke_tpu/utils/profiling.py``):
a ``torch.profiler`` trace exported as a Chrome trace, and ``StepTimer``
with JAX's percentile summary and its JSON file."""
from __future__ import annotations

import contextlib
import json
import os
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def trace(log_dir, enabled=True):
    """Profile the block with ``torch.profiler`` (the CPU, and the card when
    CUDA is available) and write ``<log_dir>/trace.json`` (open it in
    Perfetto or chrome://tracing).  Yields the profiler, or None when not
    ``enabled``."""
    if not enabled:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Per-step wall time (use as a context manager around each step) with a
    percentile summary, written as JSON to ``log_path`` when given.  The
    caller synchronises the card inside the block where the step's end must
    be the device's."""

    def __init__(self, log_path=None):
        self.times = []
        self.log_path = log_path
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)

    def summary(self):
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        s = {
            "n": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "max_s": float(arr.max()),
        }
        if self.log_path:
            with open(self.log_path, "w") as f:
                json.dump(s, f, indent=2)
        return s
