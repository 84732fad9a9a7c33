"""The span window: ``torch.profiler`` over a few units of work with the
port's program spans on (``ipoke_tpu_torch.utils.profiling.spans``), read
into each span's device time and the device's idle time split by the span
open on the calling thread.  The per-layer readers of ``SPAN_METRICS``
(``metrics/<name>.py``) read it from the readings' ``span_window``, and
``breakdown`` gives its ``spans`` and ``idle_by_span``.  Where the port has
no spans (``window`` returns None) none of them is reported.

The drivers' traced runs do not open the window.  ``profile_cell`` sets up
a cell as its driver does, warms it up, and profiles ``trace_calls`` or
``trace_steps`` units twice, spans off (``trace.traced``, the traced run's
own window) and then spans on:

    python3 -m portbench.spans --workload <cell> --seed <n>

prints one JSON line with both windows' milliseconds per unit, the span
metrics of the cell, and the breakdown.

How a trace is read (``summarize``):
- An event marked ``is_user_annotation()`` is a span, never device work,
  its copy on the device's timeline included.
- Each kernel, copy or set is matched by its correlation id to the host
  runtime call that launched it (``cudaLaunchKernel`` and the like), and
  given to the innermost span open at that call's start on the launching
  thread, else on any other thread: a backward launches from autograd's
  thread while the step's thread waits in ``torch.autograd.grad``.  Work
  under no span is the harness's; work whose launch is not in the trace
  is ``(unlinked)``.
- A span's device time is the union of the intervals given to it or to a
  span inside it.
- The device's idle time (the window less the union of all device
  intervals) is split by the spans open on the thread that opened the
  window (``portbench.window``); idle time under none is the harness's.
  Each idle gap is placed on the host's clock by the launch that ends it
  (``_idle_on_host``): the profiler's host and device clocks drift apart.
"""
from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

if __package__ in (None, ""):   # run as a script: the checkout's root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import layout  # noqa: E402

WINDOW = "portbench.window"
HARNESS = "(harness)"
UNLINKED = "(unlinked)"
TOP = 10
SPAN_METRICS = {"sample": ("sample_flow_ms", "sample_decode_ms", "program_idle_pct.sample"),
                "gan": ("gan_dt_ms", "gan_ds_ms", "gan_plan_idle_ms", "program_idle_pct.train")}


def _profiling():
    """The port's tracing module, or None where the port has no spans."""
    try:
        from ipoke_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "spans") else None


def window(units, n, device):
    """Run ``units()`` (``n`` units of work) under the profiler with spans on,
    inside the harness's own span; the readings per unit (``summarize``).
    None where the port has no spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    profiling = _profiling()
    if profiling is None:
        return None
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=activities) as prof, profiling.spans():
        with profiling.span(WINDOW):
            units()
            sync()
    return summarize(prof.profiler.kineto_results.events(), n)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _length(intervals):
    return sum(e - s for s, e in _merge(intervals))


def _timeline(spans):
    """[(start, end, chain)] of one thread's spans: over each stretch of time
    in which a span is open, the names of those open, outermost first."""
    out, stack, t = [], [], None

    def close(upto):
        nonlocal t
        while stack and stack[-1][0] <= upto:
            end = stack[-1][0]
            if end > t:
                out.append((t, end, tuple(n for _, n in stack)))
            t = end
            stack.pop()

    for s, e, name in sorted(spans, key=lambda v: (v[0], -v[1])):
        close(s)
        if stack and s > t:
            out.append((t, s, tuple(n for _, n in stack)))
        t = s
        stack.append((min(e, stack[-1][0]) if stack else e, name))
    close(float("inf"))
    return out


def _chain_at(timeline, starts, t):
    i = bisect.bisect_right(starts, t) - 1
    return timeline[i][2] if i >= 0 and t < timeline[i][1] else ()


def _busy(dev):
    """The union of the device intervals ``dev`` ([start, end, correlation
    id]): [start, end, correlation id of the work that starts it]."""
    out = []
    for s, e, corr in sorted(dev):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e, corr])
    return out


def _idle_on_host(busy, runtime, ws, we):
    """The device's idle gaps between the intervals ``busy`` as sorted
    intervals of the host's clock, inside the window [ws, we].

    The profiler stamps host events and device activity on two clocks that
    drift apart by milliseconds over a window of seconds, so a gap is not
    placed by its device times.  The device idles until the host launches
    more work, which then starts within microseconds: a gap of length g
    ends at the host's launch of the work that ends it, and lies at
    [launch - g, launch].  The gap before the first launch starts with the
    window; what is left of the window's idle time (window - busy - the
    gaps) lies at its end, where the harness waits for the device."""
    shifts = [s - runtime[c][0] if c in runtime else None for s, _, c in busy]
    known = [d for d in shifts if d is not None]
    last = known[0] if known else 0
    gaps = []
    for i, (s, _, _) in enumerate(busy):
        last = shifts[i] if shifts[i] is not None else last
        a = ws if i == 0 else busy[i - 1][1] - last
        gaps.append((max(a, ws), min(s - last, we)))
    gaps = [(a, b) for a, b in gaps if b > a]
    tail = (we - ws) - sum(e - s for s, e, _ in busy) - sum(b - a for a, b in gaps)
    if not busy:
        tail = we - ws
    if tail > 0:
        gaps.append((we - tail, we))
    return sorted(gaps)


def summarize(events, n):
    """The readings of a span window's trace, per unit of ``n``: the window's
    ``window_ms``, ``busy_ms`` and ``idle_ms``, ``device_ops``, ``spans``
    ({name: {count, host_ms, device_ms, idle_ms}}; device and idle time of a
    span include its children's), ``idle_by_span`` ({innermost span or
    ``HARNESS``: idle ms}), ``harness_ms`` and ``unlinked_ms`` (device time
    under no span and with no launch found)."""
    spans, dev, runtime = defaultdict(list), [], {}
    win = None
    for e in events:
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        on_device = str(e.device_type()).endswith("CUDA")
        if e.is_user_annotation():
            if on_device:
                continue
            if e.name() == WINDOW:
                win = (start, end, e.start_thread_id())
            else:
                spans[e.start_thread_id()].append((start, end, e.name()))
        elif on_device:
            dev.append((start, end, e.correlation_id()))
        elif e.name().startswith("cu"):   # a CUDA runtime or driver call
            runtime[e.correlation_id()] = (start, e.start_thread_id())
    if win is None:
        raise ValueError(f"portbench: the trace holds no {WINDOW} span")
    ws, we, main = win
    lines = {tid: _timeline(s) for tid, s in spans.items()}
    starts = {tid: [seg[0] for seg in line] for tid, line in lines.items()}

    def owner(corr):
        if corr not in runtime:
            return (UNLINKED,)
        t, tid = runtime[corr]
        if tid in lines:
            chain = _chain_at(lines[tid], starts[tid], t)
            if chain:
                return chain
        other = [_chain_at(lines[k], starts[k], t) for k in lines if k != tid]
        return max(other, key=len, default=()) or (HARNESS,)

    device = defaultdict(list)
    for s, e, corr in dev:
        for name in owner(corr):
            device[name].append((s, e))
    busy = _busy(dev)
    idle_gaps = _idle_on_host(busy, runtime, ws, we)
    idle_by, idle_under = defaultdict(int), defaultdict(int)

    def add_idle(chain, length):
        idle_by[chain[-1] if chain else HARNESS] += length
        for name in chain:
            idle_under[name] += length

    line, j = lines.get(main, []), 0
    for a, b in idle_gaps:
        while j < len(line) and line[j][1] <= a:
            j += 1
        pos, k = a, j
        while k < len(line) and line[k][0] < b:
            lo, hi = max(line[k][0], a), min(line[k][1], b)
            if lo > pos:
                add_idle((), lo - pos)
            add_idle(line[k][2], hi - lo)
            pos, k = hi, k + 1
        if pos < b:
            add_idle((), b - pos)

    ms = 1e-6 / n
    table = {}
    for name in sorted({s[2] for ss in spans.values() for s in ss}):
        inst = [(s, e) for ss in spans.values() for s, e, nm in ss if nm == name]
        table[name] = {"count": len(inst) / n, "host_ms": sum(e - s for s, e in inst) * ms,
                       "device_ms": _length(device.get(name, [])) * ms,
                       "idle_ms": idle_under.get(name, 0) * ms}
    return {"units": n, "window_ms": (we - ws) * ms, "busy_ms": sum(e - s for s, e, _ in busy) * ms,
            "idle_ms": sum(b - a for a, b in idle_gaps) * ms, "device_ops": len(dev) / n,
            "spans": table, "idle_by_span": {k: v * ms for k, v in idle_by.items()},
            "harness_ms": _length(device.get(HARNESS, [])) * ms,
            "unlinked_ms": _length(device.get(UNLINKED, [])) * ms}


def breakdown(sw):
    """The span window's two breakdown lists, per unit: ``spans`` [name,
    count, host ms, device ms] by device time (with the harness's and the
    unlinked device time), ``idle_by_span`` [name, idle ms], longest first,
    at most ``TOP``."""
    rows = [[k, v["count"], v["host_ms"], v["device_ms"]] for k, v in sw["spans"].items()]
    rows += [[HARNESS, 0, 0.0, sw["harness_ms"]], [UNLINKED, 0, 0.0, sw["unlinked_ms"]]]
    idle = sorted(sw["idle_by_span"].items(), key=lambda kv: -kv[1])[:TOP]
    return {"spans": sorted(rows, key=lambda r: -r[3]), "idle_by_span": [list(kv) for kv in idle]}


def span_value(r, kind, name, key):
    """``key`` of span ``name`` in the span window of readings ``r`` of
    ``kind``; None for a cell of another kind or a window without it."""
    sw = r.get("span_window") if r.get("kind") == kind else None
    if not sw or name not in sw["spans"]:
        return None
    return sw["spans"][name][key]


def idle_pct(r, kind, name):
    """Device idle under span ``name`` over the span window's time, in %."""
    idle = span_value(r, kind, name, "idle_ms")
    return None if idle is None else 100.0 * idle / r["span_window"]["window_ms"]


def _sample_unit(ctx, drv):
    """(unit(i), units per window, warm-up units): one sampling call of the
    driver's inputs and weights."""
    from ipoke_tpu_torch.models import second_stage
    from portbench.port import port_spec
    t = ctx.traffic
    params, spec = drv.make_params(ctx), port_spec(ctx.config)

    def unit(i):
        images, pokes, z = drv.call_inputs(ctx, i)
        second_stage.forward_sample(params, spec, {"images": images, "poke": pokes}, z=z,
                                    length=t["frames"] - 1)

    return unit, t["trace_calls"], t["warmup_calls"]


def _gan_unit(ctx, drv):
    """(unit(i), units per window, warm-up units): one train step of the
    driver's nets, batches and keys."""
    state, step = drv.port_step(ctx, drv.make_nets(ctx))
    box = [state]

    def unit(i):
        box[0], _ = step(box[0], {"images": drv.batch(ctx, i)}, drv.key(ctx, i))

    return unit, ctx.traffic["trace_steps"], ctx.traffic["checked_steps"]


def profile_cell(name, seed, device, pkg=layout.PKG):
    """Set up cell ``name`` as its driver does, warm it up, and profile its
    units twice, spans off (``trace.traced``) and on (``window``): a dict of
    both windows' ms per unit, the span window's readings, the ``metrics``
    that read a value (``SPAN_METRICS`` of the cell's kind and
    ``mcf_launches_per_call``) and the span window's ``breakdown``.  None
    where the port has no spans."""
    import torch

    from portbench import trace
    from portbench.result import Ctx
    cell = layout.cell(name, pkg)
    cfg, traffic = layout.config(cell["config"], pkg), layout.traffic(cell["traffic"], pkg)
    torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
    torch.backends.cudnn.allow_tf32 = cfg["tf32"]
    ctx = Ctx(name, cell, cfg, traffic, int(seed), 0.0, True, device, time.perf_counter())
    kind = traffic["kind"]
    make = {"sample": _sample_unit, "gan": _gan_unit}[kind]
    unit, n, warm = make(ctx, layout.driver(kind, pkg))
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    for i in range(warm):
        unit(i)
    summary = trace.traced(lambda: [unit(warm + k) for k in range(n)], sync)
    sw = window(lambda: [unit(warm + n + k) for k in range(n)], n, device)
    if sw is None:
        return None
    readings = {"kind": "train" if kind == "gan" else kind, "span_window": sw}
    metrics = {m: layout.metric(m, pkg).read(readings)
               for m in SPAN_METRICS[kind] + ("mcf_launches_per_call",)}
    scalars = {k: v for k, v in sw.items() if not isinstance(v, dict)}
    return {"workload": name, "seed": int(seed), "traced_ms_per_unit": summary["window_s"] * 1e3 / n,
            "span_window": scalars, "metrics": {k: v for k, v in metrics.items() if v is not None},
            "breakdown": breakdown(sw)}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m portbench.spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    from portbench import run
    run.cache_dirs(layout.ROOT)
    import torch
    if not torch.cuda.is_available():
        sys.exit("portbench: torch.cuda.is_available() is false; the span window runs on a CUDA card")
    out = profile_cell(args.workload, args.seed, torch.device("cuda", 0))
    if out is None:
        sys.exit("portbench: the port has no program spans")
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
