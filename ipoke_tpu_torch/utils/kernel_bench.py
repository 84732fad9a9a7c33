"""Inputs and timers for the port's kernels on the CUDA card, and the sweeps
of K1 and K2 over their cluster size G.

    python -m ipoke_tpu_torch.utils.kernel_bench

The sweeps run K1 (``ops/cuda/mcf_inverse``, order A) and K2
(``ops/cuda/mcf_unit_inverse``) at B=8, hc=128 on the 8x8 latent, for C in
32, 16, 4 and 64 and every G the kernel takes at that C, and print per
launch: the kernel's own device time (``torch.profiler``), the time per
launch of a loop of launches by CUDA events (the wrapper's host cost shows
there when it exceeds the kernel's), and the bound; one JSON line at the
end.  ``chip_smoke.py`` runs the same sweeps.  Every number is the card's
own, printed beside the card's name and power limit.  ``op_overhead`` times
the host cost of calling the kernels as ``torch.library`` custom ops against
their ctypes launch (``chip_smoke.py`` runs it).
"""
from __future__ import annotations

import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ipoke_tpu_torch.flows import mcf
from ipoke_tpu_torch.nn.core import weight_norm_materialize
from ipoke_tpu_torch.ops.cuda import mcf_inverse as k1
from ipoke_tpu_torch.ops.cuda import mcf_unit_inverse as k2
from ipoke_tpu_torch.utils.profile_sample import _device_us

# H100 SXM peaks (NVIDIA data sheet, at 700 W): f32 outside the tensor
# cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
SWEEP_LEVELS = (32, 16, 4, 64)
K1_KERNEL = "mcf_inverse_kernel"
K2_KERNEL = "macow_unit_inverse_kernel"


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters, warmup=3):
    """Mean milliseconds per call over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters, kernel):
    """Mean device milliseconds per launch of the kernel whose name contains
    ``kernel``, over ``iters`` calls of ``fn``, from ``torch.profiler``."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evts = [e for e in prof.key_averages() if kernel in e.key and _device_us(e) > 0]
    count = sum(e.count for e in evts)
    if count == 0:
        raise RuntimeError(f"device_ms: the profiler saw no launch of {kernel}")
    return sum(_device_us(e) for e in evts) / 1e3 / count


# ---------------------------------------------------------------------------
# work of one MCF inverse, counted from its shapes (operations that zero
# padding skips are not counted; an FMA is 2 operations)
# ---------------------------------------------------------------------------

def mcf_flops(b, seq, par, c, hid, hc, kseq=2, kpar=3):
    cp = (kpar - 1) // 2
    seq_taps = sum(min(i, kseq) for i in range(seq))
    par_taps = sum(1 for p in range(par) for s in range(kpar) if 0 <= p + s - cp < par)
    return b * (2 * seq_taps * par_taps * c * hid + 2 * seq * par * 2 * c * (hid + hc))


def mcf_weight_floats(c, hid, hc, kseq=2, kpar=3):
    return hid * c * kseq * kpar + 2 * c * (hid + hc) + 2 * c


def bound(flops, nbytes):
    """(least ms, "operations" or "bytes") on the H100 at its peaks."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k1_work(b, s, c, hc):
    """(flops, bytes) of one K1 launch: z read, h read, out written, one MCF's
    weights read once."""
    hid = mcf.default_hidden(c)
    nbytes = 4 * (2 * b * s * s * c + b * s * s * hc + mcf_weight_floats(c, hid, hc))
    return mcf_flops(b, s, s, c, hid, hc), nbytes


def k2_work(b, s, c, hc):
    """(flops, bytes) of one K2 launch: y read, h read, out written, four
    MCFs' weights and two actnorms read once."""
    hid = mcf.default_hidden(c)
    nbytes = 4 * (2 * b * s * s * c + b * s * s * hc + 4 * mcf_weight_floats(c, hid, hc) + 4 * c)
    return 4 * mcf_flops(b, s, s, c, hid, hc), nbytes


# ---------------------------------------------------------------------------
# inputs, from a seeded generator
# ---------------------------------------------------------------------------

def mcf_params(gen, c, hc, kernel, device, gain=0.2):
    """One MCF's params (synth fill, N(0, 0.05)) with output gain ``gain``."""
    hid = mcf.default_hidden(c)
    n = lambda *s: (torch.randn(s, generator=gen) * 0.05).to(device)  # noqa: E731
    return {"net": {"shift_conv": {"w": n(hid, c, *kernel)},
                    "conv1x1": {"v": n(2 * c, hid + hc, 1, 1),
                                "g": torch.full((2 * c,), gain, device=device), "b": n(2 * c)}}}


def mcf_inputs(gen, c, hc, b, s, order, device):
    """K1's arguments for one MCF of ``order``, weights as stored:
    (z, h, w_shift, w1, b1)."""
    net = mcf_params(gen, c, hc, (2, 3) if order in "AB" else (3, 2), device)["net"]
    w1 = weight_norm_materialize(net["conv1x1"]["v"], net["conv1x1"]["g"])
    w, w1, b1 = net["shift_conv"]["w"], w1.reshape(2 * c, -1), net["conv1x1"]["b"]
    z = torch.randn(b, s, s, c, generator=gen).to(device)
    h = torch.randn(b, s, s, hc, generator=gen).to(device) if hc else None
    return z, h, w, w1, b1


def unit_params(gen, c, hc, device):
    kernels = ((2, 3), (2, 3), (3, 2), (3, 2))
    p = {f"conv{i + 1}": mcf_params(gen, c, hc, k, device) for i, k in enumerate(kernels)}
    for an in ("actnorm1", "actnorm2"):
        p[an] = {k: (torch.randn(c, generator=gen) * 0.05).to(device) for k in ("log_scale", "bias")}
    return p


def unit_inputs(gen, c, hc, b, s, device):
    """K2's arguments for one unit: (weights, [an1, an2], y, h)."""
    up = unit_params(gen, c, hc, device)
    an = [torch.stack([up[a]["log_scale"], up[a]["bias"]]) for a in ("actnorm1", "actnorm2")]
    y = torch.randn(b, s, s, c, generator=gen).to(device)
    h = torch.randn(b, s, s, hc, generator=gen).to(device) if hc else None
    return k2.unit_weights(up), an, y, h


def k1_clusters(c, hc, s):
    return k1.allowed_clusters(c, mcf.default_hidden(c), hc, 2, 3, s, s)


def k1_plan(c, hc, s):
    return k1.cluster_plan(c, mcf.default_hidden(c), hc, 2, 3, s, s)[0]


def k2_clusters(c, hc, s):
    """The G K2 takes at these shapes, with the slices of its ``slice_plan``."""
    hid = mcf.default_hidden(c)
    return k2.allowed_clusters(c, hid, hc, 2, 3, s, s, k2.slice_plan(c, hid, hc, 2, 3, s, s))


def k2_plan(c, hc, s):
    return k2.cluster_plan(c, mcf.default_hidden(c), hc, 2, 3, s, s)[0]


def sweep_k1(device, log, card, levels=SWEEP_LEVELS, b=8, s=8, hc=128, iters=100, seed=0):
    """K1 (order A) at every G it takes, for each C of ``levels``; rows as
    ``sweep_k2``'s."""
    gen = torch.Generator().manual_seed(seed)
    rows = []
    for c in levels:
        z, h, w, w1, b1 = mcf_inputs(gen, c, hc, b, s, "A", device)
        bms, by = bound(*k1_work(b, s, c, hc))
        plan = k1_plan(c, hc, s)
        for g in k1_clusters(c, hc, s):
            def run(g=g):
                return k1.mcf_inverse(z, h, w, w1, b1, cluster=g)
            dev_ms, ev_ms = device_ms(run, iters, K1_KERNEL), time_ms(run, iters)
            rows.append(dict(c=c, hc=hc, b=b, g=g, plan=g == plan, device_ms=dev_ms,
                             event_ms=ev_ms, bound_ms=bms, bound_by=by))
            log(f"sweep [{card}]: K1 B={b} C={c} hc={hc} G={g}{' (plan)' if g == plan else ''}: "
                f"{dev_ms:.4f} ms/launch on the device, {ev_ms:.4f} ms/launch by events "
                f"in a loop; bound {bms:.5f} ms ({by})")
    return rows


def sweep_k2(device, log, card, levels=SWEEP_LEVELS, b=8, s=8, hc=128, iters=100, seed=0):
    """K2 at every G it takes, for each C of ``levels``; returns one row per
    (C, G) with the kernel's device ms, the event-timed ms, the bound and
    whether G is the plan's."""
    gen = torch.Generator().manual_seed(seed)
    rows = []
    for c in levels:
        weights, an, y, h = unit_inputs(gen, c, hc, b, s, device)
        flops, nbytes = k2_work(b, s, c, hc)
        bms, by = bound(flops, nbytes)
        plan = k2_plan(c, hc, s)
        for g in k2_clusters(c, hc, s):
            def run(g=g):
                return k2.macow_unit_inverse(y, h, weights, *an, cluster=g)
            dev_ms, ev_ms = device_ms(run, iters, K2_KERNEL), time_ms(run, iters)
            rows.append(dict(c=c, hc=hc, b=b, g=g, plan=g == plan, device_ms=dev_ms,
                             event_ms=ev_ms, bound_ms=bms, bound_by=by))
            log(f"sweep [{card}]: K2 B={b} C={c} hc={hc} G={g}{' (plan)' if g == plan else ''}: "
                f"{dev_ms:.4f} ms/launch on the device, {ev_ms:.4f} ms/launch by events "
                f"in a loop; bound {bms:.5f} ms ({by})")
    return rows


def enqueue_us(fn, iters, warmup=3):
    """Host microseconds per call of ``fn`` over ``iters`` calls issued back
    to back (the launches queue on the device, which finishes after)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / iters * 1e6


def op_overhead(device, log, card, iters=200, b=8, s=8, c=32, hc=128):
    """The host cost of calling the kernels as ``torch.library`` custom ops:
    host microseconds per launch to enqueue K1 and K2 through
    ``torch.ops.ipoke.*`` and through their ctypes launch, ``iters`` calls
    each, at the level-0 shape (B=``b``, C=``c``, hc=``hc``).  Returns a dict
    of these numbers."""
    gen = torch.Generator().manual_seed(7)
    z, h, w, w1, b1 = mcf_inputs(gen, c, hc, b, s, "A", device)
    weights, an, y, hu = unit_inputs(gen, c, hc, b, s, device)
    out = {
        "k1_op_us": enqueue_us(lambda: k1.mcf_inverse(z, h, w, w1, b1), iters),
        "k1_ctypes_us": enqueue_us(lambda: k1.launch(z, h, w, w1, b1), iters),
        "k2_op_us": enqueue_us(lambda: k2.macow_unit_inverse(y, hu, weights, *an), iters),
        "k2_ctypes_us": enqueue_us(lambda: k2.launch(y, hu, weights, *an), iters),
    }
    log(f"op overhead [{card}]: host us per launch, B={b} C={c} hc={hc}: K1 op "
        f"{out['k1_op_us']:.1f} vs ctypes {out['k1_ctypes_us']:.1f}; K2 op {out['k2_op_us']:.1f} "
        f"vs ctypes {out['k2_ctypes_us']:.1f}")
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench: needs a CUDA card")
    card, dev = card_line(), torch.device("cuda", 0)
    log = lambda m: print(m, flush=True)  # noqa: E731
    rows = {"k1_sweep": sweep_k1(dev, log, card), "k2_sweep": sweep_k2(dev, log, card),
            "op_overhead": op_overhead(dev, log, card)}
    print(json.dumps({"card": card, **rows}))


if __name__ == "__main__":
    main()
