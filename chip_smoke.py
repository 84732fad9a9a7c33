#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ipoke_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device  the card's name and power limit (nvidia-smi), torch and CUDA
             versions; TF32 off for every f32 conv and matmul.
  2. build   nvcc builds both kernels from csrc/, one process each, in
             parallel; registers, shared memory and spills per kernel.
  3. kernels K1 (one MCF inverse, all four orders) and K2 (a MaCowUnit
             inverse) against their plain PyTorch versions at the flagship's
             shapes (B=8, 8x8 latent, C=32 and C=4, with and without h),
             each timed with CUDA events beside its bound.
  4. slice   iper_128 at full width, params synthesised on the card from a
             seed, bf16 decode: a few requests of 8 through forward_sample on
             the default backend 'cuda_unit' (K2, 200 launches per call) and
             one on the option 'cuda' (K1, 800 launches), launch counts read
             around them; then one batch through 'cuda_unit', 'cuda' and
             'scan' (plain) with non-zero flow output gains, compared.
  5. report  a JSON line of kernels, the card's line, and last
             {"ok": true, "device": {...}}.
Every time, rate and memory figure printed is this card's, at the power
limit printed beside it.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if not (ROOT / "ipoke_tpu_torch" / "__init__.py").is_file():
    sys.exit("chip_smoke: ipoke_tpu_torch/ not found beside this script; run it from a checkout")
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from ipoke_tpu_torch import registry  # noqa: E402
from ipoke_tpu_torch.flows import mcf  # noqa: E402
from ipoke_tpu_torch.models import second_stage  # noqa: E402
from ipoke_tpu_torch.ops.cuda import _build  # noqa: E402
from ipoke_tpu_torch.ops.cuda import mcf_inverse as k1  # noqa: E402
from ipoke_tpu_torch.ops.cuda import mcf_unit_inverse as k2  # noqa: E402
from ipoke_tpu_torch.utils import synth  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, at 700 W): f32 outside the tensor
# cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

KERNEL_TOL = 2e-4          # tests/test_pallas_mcf.py, tests/test_pallas_unit.py
BATCH, LATENT, HC = 8, 8, 128
REQUESTS = 3
# Flow output-conv gain of the backend cross-check: with the zeroed gains of
# zero_flow_output_convs every MCF is the identity and the check proves nothing.
CROSS_GAIN = 0.02
# The cross-check decodes in f32: kernel and plain sums differ by ~1 ulp per
# MCF, 800 MCFs deep, and the decoder adds its own cuDNN f32 sums.
CROSS_TOL = 2e-3


def log(msg):
    print(msg, flush=True)


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
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def mcf_params(gen, c, hc, kernel, device, gain=0.2):
    """One MCF's params (synth fill, N(0, 0.05)) with output gain ``gain``."""
    hid = mcf.default_hidden(c)
    n = lambda *s: (torch.randn(s, generator=gen) * 0.05).to(device)  # noqa: E731
    return {"net": {"shift_conv": {"w": n(hid, c, *kernel)},
                    "conv1x1": {"v": n(2 * c, hid + hc, 1, 1),
                                "g": torch.full((2 * c,), gain, device=device), "b": n(2 * c)}}}


def unit_params(gen, c, hc, device):
    kernels = ((2, 3), (2, 3), (3, 2), (3, 2))
    p = {f"conv{i + 1}": mcf_params(gen, c, hc, k, device) for i, k in enumerate(kernels)}
    for an in ("actnorm1", "actnorm2"):
        p[an] = {k: (torch.randn(c, generator=gen) * 0.05).to(device) for k in ("log_scale", "bias")}
    return p


def phase_kernels(device, card, c_levels=(32, 4), b=BATCH, s=LATENT, hc_full=HC,
                  flagship_levels=None):
    """Each kernel against its plain version, and timed, at the flagship's
    shapes; ``card`` labels the times."""
    gen = torch.Generator().manual_seed(0)
    report = {}
    for name in ("mcf_inverse", "macow_unit_inverse"):
        report[name] = {"max_abs_err": 0.0}
    for c in c_levels:
        hid = mcf.default_hidden(c)
        for hc in (hc_full, 0):
            z = (torch.randn(b, s, s, c, generator=gen)).to(device)
            h = torch.randn(b, s, s, hc, generator=gen).to(device) if hc else None
            # K1, all four orders through flows.mcf (canonicalised inputs)
            for order in "ABCD":
                kernel = (2, 3) if order in "AB" else (3, 2)
                p = mcf_params(gen, c, hc, kernel, device)
                out = mcf.inverse(p, z, h, order=order, backend="cuda")
                ref = mcf.inverse(p, z, h, order=order, backend="scan")
                torch.cuda.synchronize()
                err = (out - ref).abs().max().item()
                log(f"kernels: K1 order {order} C={c} hc={hc}: max |kernel - plain| {err:.3g}")
                if not err <= KERNEL_TOL * (1 + ref.abs().max().item()):
                    raise SystemExit(f"K1 disagrees with its plain version: {err}")
                report["mcf_inverse"]["max_abs_err"] = max(report["mcf_inverse"]["max_abs_err"], err)
            # K2
            up = unit_params(gen, c, hc, device)
            weights = k2.unit_weights(up)
            an = [torch.stack([up[a]["log_scale"], up[a]["bias"]]) for a in ("actnorm1", "actnorm2")]
            out = k2.macow_unit_inverse(z, h, weights, *an)
            ref = k2.macow_unit_inverse_plain(z, h, weights, *an)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            log(f"kernels: K2 C={c} hc={hc}: max |kernel - plain| {err:.3g}")
            if not err <= KERNEL_TOL * (1 + ref.abs().max().item()):
                raise SystemExit(f"K2 disagrees with its plain version: {err}")
            report["macow_unit_inverse"]["max_abs_err"] = max(
                report["macow_unit_inverse"]["max_abs_err"], err)

            # timing at this shape, canonical order A for K1
            w, w1, b1 = weights[0]
            flops1 = mcf_flops(b, s, s, c, hid, hc)
            bytes1 = 4 * (2 * z.numel() + (h.numel() if hc else 0) + mcf_weight_floats(c, hid, hc))
            flops2 = 4 * flops1
            bytes2 = 4 * (2 * z.numel() + (h.numel() if hc else 0)
                          + 4 * mcf_weight_floats(c, hid, hc) + 4 * c)
            rows = (("mcf_inverse", lambda: k1.mcf_inverse(z, h, w, w1, b1),
                     lambda: k1.mcf_inverse_plain(z, h, w, w1, b1), flops1, bytes1),
                    ("macow_unit_inverse", lambda: k2.macow_unit_inverse(z, h, weights, *an),
                     lambda: k2.macow_unit_inverse_plain(z, h, weights, *an), flops2, bytes2))
            for name, kern, plain, flops, nbytes in rows:
                ms, plain_ms = time_ms(kern, 200), time_ms(plain, 20)
                bms, by = bound(flops, nbytes)
                log(f"kernels [{card}]: {name} B={b} C={c} hid={hid} hc={hc}: {ms:.4f} ms/launch, "
                    f"plain {plain_ms:.4f} ms, bound {bms:.5f} ms ({by}; {flops / 1e6:.1f} MFLOP, "
                    f"{nbytes / 1e6:.3f} MB), {flops / ms / 1e9:.1f} GFLOP/s")
                if c == c_levels[0] and hc == hc_full:   # the level-0 shape of the main path
                    report[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
    # K2 at every level of the flagship, for its share of one forward_sample
    if flagship_levels:
        total = 0.0
        for c, n_steps in flagship_levels:
            up = unit_params(gen, c, hc_full, device)
            weights = k2.unit_weights(up)
            an = [torch.stack([up[a]["log_scale"], up[a]["bias"]]) for a in ("actnorm1", "actnorm2")]
            z = torch.randn(b, s, s, c, generator=gen).to(device)
            h = torch.randn(b, s, s, hc_full, generator=gen).to(device)
            ms = time_ms(lambda: k2.macow_unit_inverse(z, h, weights, *an), 50)
            total += 4 * n_steps * ms
            log(f"kernels [{card}]: K2 level C={c}: {ms:.4f} ms/launch x {4 * n_steps} launches")
        log(f"kernels [{card}]: K2 launches of one forward_sample (B={b}) sum to {total:.2f} ms")
        report["macow_unit_inverse"]["per_sample_call_ms"] = total
    return report


def make_requests(device, n, b, spec, seed=1000):
    """n requests of b examples, each from its own seeded generator:
    (batch dict, fixed z)."""
    fs = spec.first_stage
    out = []
    for r in range(n):
        g = torch.Generator(device=device).manual_seed(seed + r)
        batch = {"images": torch.randn(b, fs.max_frames, fs.spatial_size, fs.spatial_size, 3,
                                       generator=g, device=device).clamp_(-1, 1),
                 "poke": torch.randn(b, fs.spatial_size, fs.spatial_size, 2, generator=g, device=device)}
        z = torch.randn(b, spec.latent_size, spec.latent_size, spec.flow_in_channels,
                        generator=g, device=device)
        out.append((batch, z))
    return out


def phase_slice(device, card, spec, params, n_requests=REQUESTS, b=BATCH):
    """The main path: ``n_requests`` requests through forward_sample on the
    default backend 'cuda_unit' (K2), then one on the option 'cuda' (K1);
    ``card`` labels the times.  Both launch counters are zeroed just before
    the first request and read just after the last.  Returns the latencies of
    the 'cuda_unit' requests and each kernel's launches."""
    requests = make_requests(device, n_requests + 1, b, spec)
    backends = ["cuda_unit"] * n_requests + ["cuda"]
    units = sum(spec.flow.num_steps) * 4
    want_launches = {"cuda_unit": (0, units), "cuda": (4 * units, 0)}   # (K1, K2) per call
    fs = spec.first_stage
    want = (1, b, fs.max_frames - 1, fs.spatial_size, fs.spatial_size, 3)
    lat = []
    k1.mcf_inverse.launches = 0
    k2.macow_unit_inverse.launches = 0
    for i, ((batch, z), backend) in enumerate(zip(requests, backends)):
        s = replace(spec, flow=replace(spec.flow, mcf_backend=backend))
        before = (k1.mcf_inverse.launches, k2.macow_unit_inverse.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vid = second_stage.forward_sample(params, s, batch, z=z)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if backend == "cuda_unit":
            lat.append(dt)
        n = (k1.mcf_inverse.launches - before[0], k2.macow_unit_inverse.launches - before[1])
        finite = bool(torch.isfinite(vid).all())
        log(f"slice [{card}]: request {i} on '{backend}': {dt * 1e3:.1f} ms, shape "
            f"{tuple(vid.shape)}, finite {finite}, K1/K2 launches {n[0]}/{n[1]}")
        if tuple(vid.shape) != want or not finite or n != want_launches[backend]:
            raise SystemExit(f"slice: request {i} failed (shape {tuple(vid.shape)} want {want}, "
                             f"finite {finite}, K1/K2 launches {n} want {want_launches[backend]})")
    launches = {"mcf_inverse": k1.mcf_inverse.launches,
                "macow_unit_inverse": k2.macow_unit_inverse.launches}
    return {"latency_s": lat, "launches": launches}


def phase_cross_check(device, spec, params, b=BATCH):
    """One batch through 'cuda_unit', 'cuda' and 'scan', f32 decode, with flow
    output gains CROSS_GAIN."""
    gain, tol = CROSS_GAIN, CROSS_TOL
    spec = replace(spec, first_stage=replace(spec.first_stage, decode_dtype="f32"))
    params = dict(params, flow=synth.set_flow_output_gains(params["flow"], gain))
    (batch, z), = make_requests(device, 1, b, spec, seed=2000)
    vids = {}
    for backend in ("cuda_unit", "cuda", "scan"):
        s = replace(spec, flow=replace(spec.flow, mcf_backend=backend))
        vids[backend] = second_stage.forward_sample(params, s, batch, z=z)
    ref = vids["scan"]
    if not bool(torch.isfinite(ref).all()):
        raise SystemExit(f"cross-check: the plain video is not finite at gain {gain}")
    for backend in ("cuda_unit", "cuda"):
        err = (vids[backend] - ref).abs().max().item()
        log(f"cross-check (flow output gain {gain}, f32 decode): max |{backend} - scan| "
            f"{err:.3g} (tolerance {tol}); video range [{ref.min().item():.3f}, {ref.max().item():.3f}]")
        if not err <= tol:
            raise SystemExit(f"cross-check: {backend} disagrees with scan: {err}")


def ptxas_report(log_text):
    """registers / shared memory / spills lines of nvcc -Xptxas -v."""
    keep = [ln.strip() for ln in log_text.splitlines()
            if re.search(r"registers|spill|smem|Compiling entry", ln)]
    return keep


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this smoke run needs a CUDA card")
    device = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {card} | torch {torch.__version__} CUDA {torch.version.cuda} | "
        f"{torch.cuda.device_count()} visible")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"device: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    t0 = time.perf_counter()
    infos = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s wall for {len(infos)} kernels (parallel nvcc)")
    for name, info in infos.items():
        log(f"build: {name}: {info.seconds:.1f} s, {info.path.name}")
        for line in ptxas_report(info.log):
            log(f"build:   {line}")

    spec = registry.build_specs(registry.MODELS[registry.FLAGSHIP])
    spec = replace(spec, first_stage=replace(spec.first_stage, decode_dtype="bf16")).validate()
    levels = list(zip(spec.flow.level_channels(), spec.flow.num_steps))
    kernels = phase_kernels(device, card, flagship_levels=levels)

    t0 = time.perf_counter()
    params = synth.synth_params(spec, seed=0, device=device)
    params = dict(params, flow=synth.zero_flow_output_convs(params["flow"]))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"slice: {registry.FLAGSHIP} full width, {sum(spec.flow.num_steps)} MaCowSteps in "
        f"{len(spec.flow.num_steps)} levels, {n_params / 1e9:.3f} G params "
        f"({4 * n_params / 1e9:.2f} GB f32) synthesised on the card in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    res = phase_slice(device, card, spec, params)
    peak = torch.cuda.max_memory_allocated()
    steady = res["latency_s"][1:] or res["latency_s"]
    mean_s = sum(steady) / len(steady)
    log(f"slice [{card}]: latency per call of {BATCH} videos on 'cuda_unit': first "
        f"{res['latency_s'][0] * 1e3:.1f} ms, then {', '.join(f'{x * 1e3:.1f}' for x in steady)} ms; "
        f"{BATCH / mean_s:.2f} videos/s; peak memory {peak / 2**30:.2f} GiB")
    phase_cross_check(device, spec, params)

    src = "ipoke_tpu_torch/csrc/{}.cu"
    rows = [
        dict(name=name, route="cuda", source=src.format(source), replaces=replaces,
             launches=res["launches"][name],
             **{k: kernels[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                              "bound_by")},
             library_ms=None)
        for name, source, replaces in (
            ("mcf_inverse", "mcf_inverse", "ipoke_tpu/ops/pallas/mcf_inverse.py:33"),
            ("macow_unit_inverse", "mcf_unit_inverse", "ipoke_tpu/ops/pallas/mcf_unit_inverse.py:44"))
    ]
    if any(r["launches"] == 0 for r in rows):
        raise SystemExit(f"a kernel of the path never launched: {rows}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()
