"""The traced window: ``torch.profiler`` over a few units of work, read into
the device's busy time (the union of its kernel, copy and set intervals),
the count of device operations, device time by kernel name, and the longest
idle gaps named by the innermost host operation open across each."""
from __future__ import annotations

import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

TOP = 10


def traced(units, sync=torch.cuda.synchronize):
    """Run ``units()`` under the profiler (host ops and device activity) and
    read the trace (``summarize``); the window's length is taken on the host
    clock between two synchronises."""
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        units()
        sync()
        window_s = time.perf_counter() - t0
    return summarize(prof.profiler.kineto_results.events(), window_s)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events, window_s):
    """The readings of a trace: ``busy_s``, ``window_s``, ``device_ops`` (count),
    ``kernel_s`` by name, ``top_ops`` and ``idle_gaps`` ([name, seconds], longest
    first, at most ``TOP`` each)."""
    dev, host = [], []
    for e in events:
        span = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        (dev if str(e.device_type()).endswith("CUDA") else host).append(span)
    by_name = defaultdict(int)
    for s, e, n in dev:
        by_name[n] += e - s
    merged = _merge([(s, e) for s, e, _ in dev])
    busy_ns = sum(e - s for s, e in merged)
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(merged, merged[1:])), reverse=True)[:TOP]
    idle = []
    for length, s, e in gaps:
        mid = (s + e) // 2
        open_ops = [(he - hs, n) for hs, he, n in host if hs <= mid <= he]
        idle.append([min(open_ops)[1] if open_ops else "(no host op open)", length / 1e9])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_ns / 1e9, "window_s": window_s, "device_ops": len(dev),
            "kernel_s": {n: t / 1e9 for n, t in by_name.items()},
            "top_ops": [[n, t / 1e9] for n, t in top], "idle_gaps": idle}


def kernel_seconds(summary, names):
    """Device seconds of the kernels whose names contain any of ``names``."""
    return sum(t for n, t in summary["kernel_s"].items() if any(k in n for k in names))
