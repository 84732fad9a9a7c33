#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ipoke_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device  the card's name and power limit (nvidia-smi), torch and CUDA
             versions; TF32 off for every f32 conv and matmul.
  2. build   nvcc builds both kernels from csrc/, one process each, in
             parallel; registers, shared memory and spills per kernel.
  3. kernels K1 (one MCF inverse, all four orders in their native
             orientation) and K2 (a MaCowUnit inverse), each one
             thread-block cluster of G CTAs per example, against their plain
             PyTorch versions at C=32, 4 and 64 at every G they take, at the
             flagship's shapes (B=8, 8x8 latent, with and without h); each
             timed beside its bound at the level-0 shape and its planned G,
             swept over G at C=32, 16, 4 and 64 (hc=128), and timed at every
             flagship level at its planned G for its share of one call.
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
from ipoke_tpu_torch.models import second_stage  # noqa: E402
from ipoke_tpu_torch.ops.cuda import _build  # noqa: E402
from ipoke_tpu_torch.ops.cuda import mcf_inverse as k1  # noqa: E402
from ipoke_tpu_torch.ops.cuda import mcf_unit_inverse as k2  # noqa: E402
from ipoke_tpu_torch.utils import synth  # noqa: E402
from ipoke_tpu_torch.utils.kernel_bench import (  # noqa: E402
    K1_KERNEL, K2_KERNEL, bound, card_line, device_ms, k1_clusters, k1_plan, k1_work,
    k2_clusters, k2_plan, k2_work, mcf_inputs, sweep_k1, sweep_k2, time_ms, unit_inputs)

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


def phase_kernels(device, card, k1_levels=(32, 4, 64), k2_levels=(32, 4, 64),
                  sweep_levels=(32, 16, 4, 64), b=BATCH, s=LATENT, hc_full=HC,
                  flagship_levels=None):
    """Each kernel against its plain version at every cluster size G it
    takes, and timed, at the flagship's shapes (level 0 is ``k1_levels[0]``
    = ``k2_levels[0]``); each swept over G; ``card`` labels the times."""
    gen = torch.Generator().manual_seed(0)
    report = {name: {"max_abs_err": 0.0} for name in ("mcf_inverse", "macow_unit_inverse")}

    def check(name, label, out, ref):
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        log(f"kernels: {label}: max |kernel - plain| {err:.3g}")
        if not err <= KERNEL_TOL * (1 + ref.abs().max().item()):
            raise SystemExit(f"{label} disagrees with its plain version: {err}")
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)

    def timed(name, kernel, label, kern, plain, flops, nbytes):
        ms, ev_ms, plain_ms = device_ms(kern, 100, kernel), time_ms(kern, 100), time_ms(plain, 20)
        bms, by = bound(flops, nbytes)
        log(f"kernels [{card}]: {label}: {ms:.4f} ms/launch on the device ({ev_ms:.4f} by "
            f"events in a loop), plain {plain_ms:.4f} ms, bound {bms:.5f} ms ({by}; "
            f"{flops / 1e6:.1f} MFLOP, {nbytes / 1e6:.3f} MB), {flops / ms / 1e9:.1f} GFLOP/s")
        report[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)

    # K1 in all four orders, at every cluster size it takes
    for c in k1_levels:
        for hc in (hc_full, 0):
            for order in k1.ORDERS:
                z, h, w, w1, b1 = mcf_inputs(gen, c, hc, b, s, order, device)
                ref = k1.mcf_inverse_plain(z, h, w, w1, b1, order)
                for g in k1_clusters(c, hc, s):
                    check("mcf_inverse", f"K1 order {order} C={c} hc={hc} G={g}",
                          k1.mcf_inverse(z, h, w, w1, b1, order, cluster=g), ref)
                if c == k1_levels[0] and hc == hc_full and order == "A":
                    g = k1_plan(c, hc, s)   # the level-0 shape, at the plan's G
                    timed("mcf_inverse", K1_KERNEL, f"K1 B={b} C={c} hc={hc} order A G={g} (plan)",
                          lambda: k1.mcf_inverse(z, h, w, w1, b1),
                          lambda: k1.mcf_inverse_plain(z, h, w, w1, b1), *k1_work(b, s, c, hc))
                    report["mcf_inverse"]["cluster"] = g

    # K2 at every cluster size it takes
    for c in k2_levels:
        for hc in (hc_full, 0):
            weights, an, y, h = unit_inputs(gen, c, hc, b, s, device)
            ref = k2.macow_unit_inverse_plain(y, h, weights, *an)
            for g in k2_clusters(c, hc, s):
                check("macow_unit_inverse", f"K2 C={c} hc={hc} G={g}",
                      k2.macow_unit_inverse(y, h, weights, *an, cluster=g), ref)
            if c == k2_levels[0] and hc == hc_full:   # the level-0 shape, at the plan's G
                g = k2_plan(c, hc, s)
                timed("macow_unit_inverse", K2_KERNEL, f"K2 B={b} C={c} hc={hc} G={g} (plan)",
                      lambda: k2.macow_unit_inverse(y, h, weights, *an),
                      lambda: k2.macow_unit_inverse_plain(y, h, weights, *an), *k2_work(b, s, c, hc))
                report["macow_unit_inverse"]["cluster"] = g

    # the sweeps over G at B=8, hc=128
    report["mcf_inverse"]["sweep"] = sweep_k1(device, log, card, sweep_levels, b, s, hc_full)
    report["macow_unit_inverse"]["sweep"] = sweep_k2(device, log, card, sweep_levels, b, s, hc_full)

    # each kernel at every level of the flagship at its planned G, for its
    # share of one forward_sample: per MaCowStep, 16 K1 launches (4 of each
    # order) under 'cuda', 4 K2 launches under 'cuda_unit'
    if flagship_levels:
        total = {"mcf_inverse": 0.0, "macow_unit_inverse": 0.0}
        for c, n_steps in flagship_levels:
            mcfs = {o: mcf_inputs(gen, c, hc_full, b, s, o, device) for o in k1.ORDERS}
            ms1 = device_ms(lambda: [k1.mcf_inverse(*mcfs[o], o) for o in k1.ORDERS], 25, K1_KERNEL)
            weights, an, y, h = unit_inputs(gen, c, hc_full, b, s, device)
            ms2 = device_ms(lambda: k2.macow_unit_inverse(y, h, weights, *an), 50, K2_KERNEL)
            total["mcf_inverse"] += 16 * n_steps * ms1
            total["macow_unit_inverse"] += 4 * n_steps * ms2
            log(f"kernels [{card}]: level C={c}: K1 G={k1_plan(c, hc_full, s)} {ms1:.4f} ms/launch "
                f"on the device (mean of the four orders) x {16 * n_steps} launches; "
                f"K2 G={k2_plan(c, hc_full, s)} {ms2:.4f} ms/launch x {4 * n_steps} launches")
        for name, label, backend in (("mcf_inverse", "K1", "cuda"),
                                     ("macow_unit_inverse", "K2", "cuda_unit")):
            log(f"kernels [{card}]: {label} launches of one forward_sample (B={b}, '{backend}') "
                f"sum to {total[name]:.2f} ms")
            report[name]["per_sample_call_ms"] = total[name]
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
    for r in rows:   # each kernel's G at level 0
        r["cluster"] = kernels[r["name"]]["cluster"]
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
