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
  5. serve   the serving path on the same params: the port's HTTP server
             (127.0.0.1, a free port) over a SampleBatcher (max_batch 8,
             30 ms window), every bucket warmed, then the port's load test
             (2 spawned processes x 8 connections, 48 requests, npy_u8);
             launch counts read around it (K2 200 per batch run).  Then, on
             a batcher with flow output gains CROSS_GAIN and f32 decode, one
             served npy video against forward_sample on the z that
             utils/prng draws from its seed, and three requests alone
             against the same three in one batch.  Before it, the host cost
             of the custom ops per launch against the ctypes launch.
  6. distill the distillation path on the slice's params as the frozen
             teacher (seed 0, flow output convs zeroed: the port's
             synth-stable teacher), B=8: a direct student (hidden 256, depth
             6) from JAX's init, DISTILL_DIRECT_STEPS steps of optax's adam
             (K2 200 launches per step, the teacher's reverse; the loss must
             fall); a flow student of one MaCowStep per level,
             DISTILL_FLOW_STEPS steps with finite NLL, then
             reverse(forward(m)) back to m within TRAIN_TOL (60 K2
             launches); then forward_sample_student with the direct student
             trained above, timed beside the slice's calls.
  7. artifact serving artifacts exported on the card (torch.export, K2 as
             the custom op ipoke::macow_unit_inverse): the flow sampler at
             ARTIFACT_FLOW_BUCKETS with flow output gains CROSS_GAIN, loaded
             and held to the live forward_sample on the same z within
             CUDA_BATCH_TOL (200 K2 launches per call); the direct student of
             the distill phase with the u8 wire at buckets 1, 2, 4, 8,
             served over HTTP by the port's server (SERVE_REQUESTS npy_u8
             requests, 2 processes x 8 connections).  Export seconds per
             bucket and file sizes are printed.
  8. train   the training path: experiments/second_stage.train on iper_128
             at full width and depth from JAX's init at seed 0, synthetic
             data (B=8, 10 frames of 128^2), torch-Adam (lr 1e-3 after 2
             warm-up steps, weight decay 1e-5), one warm-up step and 5 timed
             steps; no kernel launches in a step.  Checked: finite losses and
             grad norms, the float leaves moved, the frozen and integer leaves
             bitwise as initialised, last.npz (the whole train state, in a
             temporary directory) reloads to the trained params bitwise, and
             reverse(forward(x)) on the trained flow returns the motion latent
             within TRAIN_TOL with 200 K2 launches.
  9. report  a JSON line of the train phase, one of the distill and
             artifact phases, a JSON line of kernels, the card's line, and
             last {"ok": true, "device": {...}}.
Every time, rate and memory figure printed is this card's, at the power
limit printed beside it.
"""
from __future__ import annotations

import http.client
import io as pyio
import json
import os
import re
import shutil
import sys
import tempfile
import threading
import time
from dataclasses import replace
from http.server import ThreadingHTTPServer
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if not (ROOT / "ipoke_tpu_torch" / "__init__.py").is_file():
    sys.exit("chip_smoke: ipoke_tpu_torch/ not found beside this script; run it from a checkout")
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ipoke_tpu_torch import registry  # noqa: E402
from ipoke_tpu_torch.ckpt import io  # noqa: E402
from ipoke_tpu_torch.ckpt.jax_bridge import bridge_second_stage  # noqa: E402
from ipoke_tpu_torch.data.synthetic import from_data_config, train_batches  # noqa: E402
from ipoke_tpu_torch.experiments import second_stage as experiment  # noqa: E402
from ipoke_tpu_torch.flows import transformer  # noqa: E402
from ipoke_tpu_torch.models import second_stage  # noqa: E402
from ipoke_tpu_torch.ops.cuda import _build  # noqa: E402
from ipoke_tpu_torch.ops.cuda import mcf_inverse as k1  # noqa: E402
from ipoke_tpu_torch.ops.cuda import mcf_unit_inverse as k2  # noqa: E402
from ipoke_tpu_torch.serve import artifact, loadtest  # noqa: E402
from ipoke_tpu_torch.serve.batcher import CUDA_BATCH_TOL, BatcherConfig, SampleBatcher  # noqa: E402
from ipoke_tpu_torch.serve.server import make_handler  # noqa: E402
from ipoke_tpu_torch.train import distill  # noqa: E402
from ipoke_tpu_torch.train import second_stage as train_ss  # noqa: E402
from ipoke_tpu_torch.utils import prng, synth  # noqa: E402
from ipoke_tpu_torch.utils.kernel_bench import (  # noqa: E402
    K1_KERNEL, K2_KERNEL, bound, card_line, device_ms, k1_clusters, k1_plan, k1_work,
    k2_clusters, k2_plan, k2_work, mcf_inputs, op_overhead, sweep_k1, sweep_k2, time_ms,
    unit_inputs)

KERNEL_TOL = 2e-4          # tests/test_pallas_mcf.py, tests/test_pallas_unit.py
BATCH, LATENT, HC = 8, 8, 128
REQUESTS = 3
# Flow output-conv gain of the backend cross-check: with the zeroed gains of
# zero_flow_output_convs every MCF is the identity and the check proves nothing.
CROSS_GAIN = 0.02
# The cross-check decodes in f32: kernel and plain sums differ by ~1 ulp per
# MCF, 800 MCFs deep, and the decoder adds its own cuDNN f32 sums.
CROSS_TOL = 2e-3
SERVE_REQUESTS, SERVE_PROCS, SERVE_CONNS = 48, 2, 8
TRAIN_STEPS = 5            # timed train steps, after one warm-up step
# reverse(forward(x)) on the trained flow against x, 50 MaCowSteps deep in f32
TRAIN_TOL = 1e-3
DISTILL_DIRECT_STEPS, DISTILL_FLOW_STEPS = 10, 3
DISTILL_LR = 1e-4          # configs/distill.yaml's distill.lr
STUDENT_CALLS = 3          # timed forward_sample_student calls, after one warm-up
# bucket 8 only: exporting the flagship flow graph is the slowest step of the
# run (PERF.md)
ARTIFACT_FLOW_BUCKETS = (8,)
ARTIFACT_STUDENT_BUCKETS = (1, 2, 4, 8)


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


def _start_server(batcher):
    """The port's HTTP server over ``batcher`` on 127.0.0.1, a free port."""
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(batcher))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread


def _stop_server(httpd, thread, batcher):
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=10)
    batcher.close()


def _http(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            raise SystemExit(f"serve: {method} {path} answered {resp.status}: {data[:200]!r}")
        return data
    finally:
        conn.close()


def phase_serve(card, spec, params, direct_s, b=BATCH, n_requests=SERVE_REQUESTS,
                procs=SERVE_PROCS, conns=SERVE_CONNS):
    """The serving path, the second path of this run: the port's HTTP server
    over a SampleBatcher (max_batch ``b``, 30 ms window) on the slice's
    params, every bucket warmed, then the port's load test (``procs``
    processes x ``conns`` connections, ``n_requests`` requests, npy_u8).
    Both launch counters are zeroed just before the warm-up and read just
    after the load test; K2 must have launched 200 times per batch run.
    ``direct_s`` are the slice phase's B=``b`` latencies, printed beside."""
    batcher = SampleBatcher(params, spec, BatcherConfig(max_batch=b, max_delay_ms=30.0))
    httpd, thread = _start_server(batcher)
    port = httpd.server_address[1]
    units = sum(spec.flow.num_steps) * 4
    try:
        k1.mcf_inverse.launches = 0
        k2.macow_unit_inverse.launches = 0
        t0 = time.perf_counter()
        batcher.warmup()
        warm_s = time.perf_counter() - t0
        res = loadtest.run(port, requests=n_requests, procs=procs, conns=conns,
                           size=spec.first_stage.spatial_size, fmt="npy_u8", timeout=600)
        stats = json.loads(_http(port, "GET", "/stats"))
        n = (k1.mcf_inverse.launches, k2.macow_unit_inverse.launches)
    finally:
        _stop_server(httpd, thread, batcher)
    n_warm = len(batcher.buckets)
    want = (0, units * (stats["batches"] + n_warm))
    direct_mean = sum(direct_s) / len(direct_s)
    log(f"serve [{card}]: {res['requests_ok']}/{n_requests} requests ok, {res['errors']} errors "
        f"({procs} processes x {conns} connections, npy_u8); {res['videos_per_s_served']:.3f} "
        f"videos/s served over {res['wall_s']:.3f} s; p50 {res['p50_s'] * 1e3:.1f} ms, "
        f"p95 {res['p95_s'] * 1e3:.1f} ms; batch sizes {stats['batch_size_histogram']}, "
        f"mean batch exec {stats['mean_batch_exec_ms']:.1f} ms, mean wait "
        f"{stats['mean_wait_ms']:.1f} ms; warm-up of buckets {batcher.buckets} {warm_s:.2f} s; "
        f"K1/K2 launches {n[0]}/{n[1]} (want {want[0]}/{want[1]} = {units} x ({stats['batches']} "
        f"batches + {n_warm} warm-up calls)); direct forward_sample B={b}: "
        f"{', '.join(f'{x * 1e3:.1f}' for x in direct_s)} ms, {b / direct_mean:.3f} videos/s")
    if (res["requests_ok"] != n_requests or res["errors"] or stats["requests"] != n_requests
            or n != want):
        raise SystemExit(f"serve: failed ({res}, stats {stats}, K1/K2 launches {n} want {want})")
    return {"launches": {"mcf_inverse": n[0], "macow_unit_inverse": n[1]}}


def phase_serve_check(device, spec, params, seeds=(11, 2**32 - 1, 2**40 + 3)):
    """What the server answers, on a batcher whose flow output gains are
    CROSS_GAIN, f32 decode: one request's npy video over HTTP against
    forward_sample on the z that utils/prng draws from its seed (CROSS_TOL),
    and the same requests alone and in one shared batch (CUDA_BATCH_TOL)."""
    spec = replace(spec, first_stage=replace(spec.first_stage, decode_dtype="f32"))
    params = dict(params, flow=synth.set_flow_output_gains(params["flow"], CROSS_GAIN))
    fs = spec.first_stage
    rng = np.random.default_rng(3000)
    reqs = [(rng.uniform(-1, 1, (fs.spatial_size, fs.spatial_size, 3)).astype(np.float32),
             rng.standard_normal((fs.spatial_size, fs.spatial_size, 2)).astype(np.float32), s)
            for s in seeds]
    batcher = SampleBatcher(params, spec, BatcherConfig(max_batch=4, max_delay_ms=200.0))
    httpd, thread = _start_server(batcher)
    try:
        x0, poke, seed = reqs[0]
        buf = pyio.BytesIO()
        np.savez(buf, x0=x0, poke=poke, seed=np.int64(seed), format=np.str_("npy"))
        served = np.load(pyio.BytesIO(_http(httpd.server_address[1], "POST", "/sample", buf.getvalue(),
                                          {"Content-Type": "application/octet-stream"})))
        z_shape = transformer.reverse_input_shape(spec.flow, 1, spec.latent_size,
                                                  spec.flow_in_channels)[1:]
        z = prng.normal_for_seeds([seed & prng.MASK], z_shape, device)
        batch = {"images": torch.from_numpy(x0).to(device)[None, None],
                 "poke": torch.from_numpy(poke).to(device)[None]}
        direct = second_stage.forward_sample(params, spec, batch, length=fs.max_frames - 1,
                                             add_first_frame=True, z=z)[0, 0].cpu().numpy()
        err = float(np.abs(served - direct).max())
        log(f"serve check (flow output gain {CROSS_GAIN}, f32 decode): max |served npy - "
            f"forward_sample on prng z| {err:.3g} (tolerance {CROSS_TOL}); shape {served.shape}, "
            f"video range [{direct.min():.3f}, {direct.max():.3f}]")
        if not (np.isfinite(served).all() and err <= CROSS_TOL):
            raise SystemExit(f"serve check: the served video disagrees with forward_sample: {err}")
        solo = [batcher.submit(x0, poke, seed, timeout=300) for x0, poke, seed in reqs]
        before = dict(batcher.stats.batch_hist)
        handles = [batcher.submit_async(x0, poke, seed) for x0, poke, seed in reqs]
        for h in handles:
            if not h.event.wait(300) or h.error is not None:
                raise SystemExit(f"serve check: a batched request failed: {h.error}")
        grew = {k: v - before.get(k, 0) for k, v in batcher.stats.batch_hist.items()
                if v != before.get(k, 0)}
        gap = max(float(np.abs(a - h.result).max()) for a, h in zip(solo, handles))
        log(f"serve check: {len(reqs)} requests alone (bucket 1) and together (batches {grew}): "
            f"max |alone - batched| {gap:.3g} (tolerance {CUDA_BATCH_TOL})")
        if grew != {4: 1} or not gap <= CUDA_BATCH_TOL:
            raise SystemExit(f"serve check: alone and batched disagree ({gap}) or did not share "
                             f"a batch ({grew})")
    finally:
        _stop_server(httpd, thread, batcher)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _counts():
    return k1.mcf_inverse.launches, k2.macow_unit_inverse.launches


def _zero_counts():
    k1.mcf_inverse.launches = 0
    k2.macow_unit_inverse.launches = 0


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def phase_distill(device, card, spec, params, slice_s, b=BATCH, direct_steps=DISTILL_DIRECT_STEPS,
                  flow_steps=DISTILL_FLOW_STEPS, student_calls=STUDENT_CALLS):
    """The distillation path on ``params`` as the frozen teacher, one fixed
    cond of ``b`` examples, step i's z from ``prng_key(100 + i)``: a direct
    student (256, 6) from JAX's init at key 0, then a flow student of one
    MaCowStep per level from key 1, then forward_sample_student of the
    trained direct student.  The launch counters are zeroed just before each
    part and read just after it.  Returns (numbers, (the trained direct
    student's params, its spec))."""
    units = 4 * sum(spec.flow.num_steps)
    (batch, _), = make_requests(device, 1, b, spec, seed=4000)
    cond = second_stage.embed_cond(params, spec, batch["images"][:, 0], batch["poke"])
    zshape = transformer.reverse_input_shape(spec.flow, b, spec.latent_size, spec.flow_in_channels)
    out = {}

    def train(student, key, steps, lr):
        init_state, step = distill.make_distill_step(spec, student, train_ss.adam(lr))
        t0 = time.perf_counter()
        state = init_state(prng.prng_key(key), device)
        _sync(device)
        init_s = time.perf_counter() - t0
        hist = []
        _zero_counts()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        for i in range(steps):
            z = prng.normal(prng.prng_key(100 + i), zshape, device)
            _sync(device)
            t0 = time.perf_counter()
            state, logs = step(state, params, z, cond)
            logs = {k: float(v) for k, v in logs.items()}   # a host read: the step has finished
            hist.append(dict(logs, ms=(time.perf_counter() - t0) * 1e3))
        n = _counts()
        peak = torch.cuda.max_memory_allocated() / 2**30 if device.type == "cuda" else 0.0
        return state, hist, n, init_s, peak

    # direct student
    ds = distill.DirectStudentSpec(hidden=256, depth=6)
    state, hist, n, init_s, peak = train(ds, 0, direct_steps, DISTILL_LR)
    for i, h in enumerate(hist):
        log(f"distill [{card}]: direct step {i}: loss {h['loss']:.6g}, teacher_finite_frac "
            f"{h['teacher_finite_frac']:.3f}, {h['ms']:.1f} ms")
    losses = [h["loss"] for h in hist]
    step_ms = _median([h["ms"] for h in hist[1:]] or [hist[0]["ms"]])
    log(f"distill [{card}]: direct student (256, 6), B={b}, lr {DISTILL_LR}: init {init_s:.2f} s; "
        f"step first {hist[0]['ms']:.1f} ms, median of the rest {step_ms:.1f} ms; loss "
        f"{losses[0]:.6g} -> {losses[-1]:.6g}; K1/K2 launches {n[0]}/{n[1]} ({n[1] / direct_steps:g} "
        f"K2 per step, want {units}); peak {peak:.2f} GiB")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and n == (0, units * direct_steps)):
        raise SystemExit(f"distill: the direct student failed (losses {losses}, K1/K2 {n})")
    out["direct"] = {"init_s": init_s, "step_ms": [h["ms"] for h in hist],
                     "step_ms_median": step_ms, "loss": losses, "peak_gib": peak,
                     "teacher_finite_frac": [h["teacher_finite_frac"] for h in hist],
                     "launches_per_step": {"mcf_inverse": n[0] / direct_steps,
                                           "macow_unit_inverse": n[1] / direct_steps}}
    sp = state["params"]
    del state

    # flow student: one MaCowStep per level
    s_spec = distill.flow_student_spec(spec.flow, (1,) * len(spec.flow.num_steps))
    fstate, fhist, n, init_s, peak = train(s_spec, 1, flow_steps, 1e-4)
    nll = [h["loss"] for h in fhist]
    s_units = 4 * sum(s_spec.num_steps)
    with torch.no_grad():
        m = distill.teacher_motion(params, spec, prng.normal(prng.prng_key(200), zshape, device), cond)
        g, _ = transformer.forward(fstate["params"], s_spec, m, cond)
        _zero_counts()
        back = transformer.reverse(fstate["params"], s_spec, g, cond)
        _sync(device)
        n_rt = _counts()
    err = (back - m).abs().max().item()
    log(f"distill [{card}]: flow student {s_spec.num_steps}: init {init_s:.2f} s; steps "
        f"{', '.join(f'{h['ms']:.1f}' for h in fhist)} ms; NLL {', '.join(f'{x:.6g}' for x in nll)}; "
        f"K1/K2 launches in the steps {n[0]}/{n[1]}; peak {peak:.2f} GiB; max |reverse(forward(m)) - m| "
        f"{err:.3g} (tolerance {TRAIN_TOL}) with K1/K2 launches {n_rt[0]}/{n_rt[1]} (want 0/{s_units})")
    if not (all(np.isfinite(nll)) and n == (0, units * flow_steps) and err <= TRAIN_TOL
            and n_rt == (0, s_units)):
        raise SystemExit(f"distill: the flow student failed (NLL {nll}, K1/K2 {n}, round trip "
                         f"{err} with {n_rt})")
    out["flow"] = {"init_s": init_s, "step_ms": [h["ms"] for h in fhist], "nll": nll,
                   "peak_gib": peak, "roundtrip_max_abs_err": err,
                   "roundtrip_launches": {"mcf_inverse": n_rt[0], "macow_unit_inverse": n_rt[1]}}
    del fstate, m, g, back

    # the trained direct student's sampler
    (batch, z), = make_requests(device, 1, b, spec, seed=5000)
    fs = spec.first_stage
    want = (1, b, fs.max_frames - 1, fs.spatial_size, fs.spatial_size, 3)
    lat = []
    _zero_counts()
    for i in range(1 + student_calls):
        _sync(device)
        t0 = time.perf_counter()
        vid = distill.forward_sample_student(params, sp, ds, spec, batch, z=z)
        _sync(device)
        lat.append((time.perf_counter() - t0) * 1e3)
    n = _counts()
    finite = bool(torch.isfinite(vid).all())
    steady = lat[1:]
    flow_ms = [x * 1e3 for x in slice_s]
    log(f"distill [{card}]: forward_sample_student ({ds.hidden}, {ds.depth}) trained above, "
        f"B={b}: first {lat[0]:.1f} ms, then {', '.join(f'{x:.1f}' for x in steady)} ms, "
        f"{b * 1e3 / (sum(steady) / len(steady)):.2f} videos/s; the flow's forward_sample "
        f"(slice phase) {', '.join(f'{x:.1f}' for x in flow_ms)} ms, "
        f"{b * 1e3 / (sum(flow_ms) / len(flow_ms)):.2f} videos/s; shape {tuple(vid.shape)}, finite "
        f"{finite}; K1/K2 launches {n[0]}/{n[1]}")
    if tuple(vid.shape) != want or not finite or n != (0, 0):
        raise SystemExit(f"distill: forward_sample_student failed ({tuple(vid.shape)}, {finite}, {n})")
    out["student_sample_ms"] = lat
    return out, (sp, ds)


def phase_artifact(device, card, spec, params, student, tmp, flow_buckets=ARTIFACT_FLOW_BUCKETS,
                   student_buckets=ARTIFACT_STUDENT_BUCKETS, b=BATCH,
                   n_requests=SERVE_REQUESTS, procs=SERVE_PROCS, conns=SERVE_CONNS):
    """Serving artifacts exported on ``device`` into ``tmp``: the flow
    sampler (flow output gains CROSS_GAIN) at ``flow_buckets``, loaded and
    run at bucket ``b`` against the live forward_sample; then the direct
    student ``student`` = (params, spec) with the u8 wire at
    ``student_buckets``, served over HTTP.  The launch counters are zeroed just before each run
    and read just after it."""
    units = 4 * sum(spec.flow.num_steps)
    gparams = dict(params, flow=synth.set_flow_output_gains(params["flow"], CROSS_GAIN))

    def export(name, **kw):
        t0 = time.perf_counter()
        artifact.export_sampler(gparams if name == "flow" else params, spec, tmp / name, **kw)
        total = time.perf_counter() - t0
        m = json.loads((tmp / name / "manifest.json").read_text())
        sizes = {f.name: f.stat().st_size for f in sorted((tmp / name).iterdir())}
        t0 = time.perf_counter()
        art = artifact.load_artifact(tmp / name, device)
        load_s = time.perf_counter() - t0
        log(f"artifact [{card}]: {name} ({m['sampler']}, wire {m['wire']}) exported in "
            f"{total:.1f} s: per bucket {', '.join(f'{k}: {v:.1f} s' for k, v in m['export_s'].items())}; "
            f"files {', '.join(f'{k} {v / 1e6:.1f} MB' for k, v in sizes.items())}; loaded in "
            f"{load_s:.1f} s")
        return art, {"export_s": m["export_s"], "export_total_s": total, "load_s": load_s,
                     "bytes": sizes}

    out = {}
    art, out["flow"] = export("flow", buckets=flow_buckets)
    nodes = sum("ipoke.macow_unit_inverse" in str(n.target) for n in art.programs[b].graph.nodes)
    (batch, _), = make_requests(device, 1, b, spec, seed=6000)
    x0, poke = batch["images"][:, 0], batch["poke"]
    z = art.draw_z(range(b))
    art.run(art.params, x0, poke, z)   # first call
    ms, n = [], []
    for _ in range(2):
        _zero_counts()
        _sync(device)
        t0 = time.perf_counter()
        got = art.run(art.params, x0, poke, z)
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        n.append(_counts())
    live_ms = []
    for _ in range(2):
        _sync(device)
        t0 = time.perf_counter()
        live = second_stage.forward_sample(gparams, spec, batch, length=art.length,
                                           add_first_frame=True, z=z)[0]
        _sync(device)
        live_ms.append((time.perf_counter() - t0) * 1e3)
    err = (got - live).abs().max().item()
    log(f"artifact [{card}]: flow bucket {b}: {nodes} ipoke::macow_unit_inverse nodes; calls "
        f"{', '.join(f'{x:.1f}' for x in ms)} ms (live forward_sample {', '.join(f'{x:.1f}' for x in live_ms)} "
        f"ms); K1/K2 launches per call {n}; max |artifact - live| {err:.3g} (tolerance "
        f"{CUDA_BATCH_TOL}); video range [{live.min().item():.3f}, {live.max().item():.3f}]")
    if nodes != units or any(x != (0, units) for x in n) or not err <= CUDA_BATCH_TOL \
            or not bool(torch.isfinite(got).all()):
        raise SystemExit(f"artifact: the flow artifact failed ({nodes} nodes, launches {n}, err {err})")
    out["flow"].update(call_ms=ms, live_ms=live_ms, max_abs_err=err, nodes=nodes,
                       launches_per_call={"mcf_inverse": n[0][0], "macow_unit_inverse": n[0][1]})
    del art, got, live, gparams

    art, out["student"] = export("student", buckets=student_buckets, student=student, wire_u8=True)
    batcher = SampleBatcher.from_artifact(art, BatcherConfig(max_batch=b, max_delay_ms=30.0))
    httpd, thread = _start_server(batcher)
    port = httpd.server_address[1]
    try:
        _zero_counts()
        t0 = time.perf_counter()
        batcher.warmup()
        warm_s = time.perf_counter() - t0
        res = loadtest.run(port, requests=n_requests, procs=procs, conns=conns,
                           size=spec.first_stage.spatial_size, fmt="npy_u8", timeout=600)
        stats = json.loads(_http(port, "GET", "/stats"))
        n = _counts()
    finally:
        _stop_server(httpd, thread, batcher)
    log(f"artifact [{card}]: student artifact served: {res['requests_ok']}/{n_requests} requests ok, "
        f"{res['errors']} errors ({procs} processes x {conns} connections, npy_u8); "
        f"{res['videos_per_s_served']:.3f} videos/s served over {res['wall_s']:.3f} s; p50 "
        f"{res['p50_s'] * 1e3:.1f} ms, p95 {res['p95_s'] * 1e3:.1f} ms; batch sizes "
        f"{stats['batch_size_histogram']}, mean batch exec {stats['mean_batch_exec_ms']:.1f} ms, "
        f"mean wait {stats['mean_wait_ms']:.1f} ms; warm-up of buckets {batcher.buckets} "
        f"{warm_s:.2f} s; K1/K2 launches {n[0]}/{n[1]}")
    if (res["requests_ok"] != n_requests or res["errors"] or stats["requests"] != n_requests
            or n != (0, 0)):
        raise SystemExit(f"artifact: serving the student failed ({res}, stats {stats}, K1/K2 {n})")
    out["student"].update(served=res, stats=stats, warm_s=warm_s,
                          launches={"mcf_inverse": n[0], "macow_unit_inverse": n[1]})
    return out


def train_config(entry, b=BATCH, steps=TRAIN_STEPS):
    """An in-memory config that trains the registry model ``entry`` at full
    width and depth on the synthetic dataset: torch-Adam, lr 1e-3 after a
    warm-up of 2 steps, weight decay 1e-5."""
    wrapper = {"min_spatial_size": entry.min_spatial_size}
    return {
        "general": {"experiment": "chip_smoke", "seed": 0},
        "first_stage": {"registry": entry.name},
        "poke_embedder": {"spec": dict(wrapper, nf_max=entry.nf_max_poke)},
        "conditioner": {"use": True, "spec": dict(wrapper, nf_max=entry.nf_max_cond)},
        "data": {"spatial_size": [entry.spatial_size] * 2, "max_frames": entry.max_frames,
                 "batch_size": b, "n_examples": 2 * b},
        "architecture": {"num_steps": list(entry.num_steps), "factor": entry.factor,
                         "flow_mid_channels_factor": entry.flow_mid_channels_factor,
                         "kernel_size": [2, 3], "transform": "affine", "prior_transform": "affine",
                         "activation": "elu", "condition_nice": False, "augmented_input": False},
        "training": {"lr": 1e-3, "weight_decay": 1e-5, "lr_scaling_max_it": 2, "n_epochs": 1,
                     "max_batches_per_epoch": 1 + steps},
    }


def _flat(tree, prefix=""):
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        return {k2: v2 for k, v in items for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


def phase_train(device, card, entry, steps=TRAIN_STEPS):
    """The training path: ``experiments/second_stage.train`` on ``entry`` at
    full width and depth, B=8, one warm-up step then ``steps`` timed steps;
    the launch counters read around it (neither kernel is on a train step).
    Then: the trained float leaves moved and the frozen and integer leaves
    did not (against a fresh ``init`` from the same seed); ``last.npz``
    reloads through ``ckpt/io`` and the bridge to the trained params bitwise;
    and ``transformer.reverse(transformer.forward(x))`` on 'cuda_unit' returns
    the batch's motion latent within TRAIN_TOL with 200 K2 launches."""
    config = train_config(entry, steps=steps)
    spec = registry.build_specs(entry)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        dirs = {k: os.path.join(tmp, k) for k in ("ckpt", "config", "generated", "log")}
        free_gb = shutil.disk_usage(tmp).free / 1e9
        k1.mcf_inverse.launches = 0
        k2.macow_unit_inverse.launches = 0
        torch.cuda.reset_peak_memory_stats()
        run = experiment.train(config, dirs, device=device, max_steps=1 + steps)
        n_step = (k1.mcf_inverse.launches, k2.macow_unit_inverse.launches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        if run["spec"] != spec:
            raise SystemExit(f"train: the config's spec is not the registry's {entry.name}")
        hist = run["history"]
        for i, h in enumerate(hist):
            log(f"train [{card}]: step {i}{' (warm-up)' if i == 0 else ''}: flow_loss "
                f"{h['flow_loss']:.6g}, nll {h['nll_loss']:.6g}, nlogdet {h['nlogdet_loss']:.6g}, "
                f"grad_norm {h['grad_norm']:.6g}, {h['step_s'] * 1e3:.1f} ms")
        step_ms = [h["step_s"] * 1e3 for h in hist]
        timed = sorted(step_ms[1:])
        median = timed[len(timed) // 2]
        n_params = sum(t.numel() for t in train_ss.leaves(run["state"].params))
        ckpt_gb = os.path.getsize(run["ckpt"]) / 1e9
        log(f"train [{card}]: {entry.name} full width, {sum(spec.flow.num_steps)} MaCowSteps in "
            f"{len(spec.flow.num_steps)} levels, {n_params / 1e9:.3f} G trainable params, B={BATCH}, "
            f"{entry.max_frames} frames of {entry.spatial_size}^2: init {run['init_s']:.2f} s; step "
            f"first {step_ms[0]:.1f} ms, median of {steps} {median:.1f} ms; peak "
            f"{peak:.2f} GiB; K1/K2 launches in the steps {n_step[0]}/{n_step[1]}; last.npz "
            f"{ckpt_gb:.2f} GB written in {run['save_s']:.1f} s ({free_gb:.0f} GB free before)")
        if not all(np.isfinite(h["flow_loss"]) and np.isfinite(h["grad_norm"]) for h in hist):
            raise SystemExit("train: a loss or grad norm is not finite")
        if n_step != (0, 0):
            raise SystemExit(f"train: a kernel launched in a train step: K1/K2 {n_step}")

        trained = {**run["frozen"], **run["state"].params}
        start = _flat(second_stage.init(prng.prng_key(config["general"]["seed"]), spec, device))
        moved = kept = 0
        for k, v in _flat(trained).items():
            same = torch.equal(v.detach(), start[k])
            trainable = k.split("/")[1] in train_ss.TRAINABLE_KEYS and v.is_floating_point()
            if trainable:
                moved += not same
            elif not same:
                raise SystemExit(f"train: the frozen or integer leaf {k} changed")
            else:
                kept += 1
        n_float = sum(v.is_floating_point() for v in train_ss.leaves(run["state"].params))
        del start
        t0 = time.perf_counter()
        saved, meta = io.load(run["ckpt"])
        back = _flat(bridge_second_stage(saved["params"], spec, device))
        load_s = time.perf_counter() - t0
        ckpt_ok = back.keys() == _flat(run["state"].params).keys() and all(
            torch.equal(back[k], v.detach()) for k, v in _flat(run["state"].params).items())
        del saved, back
        log(f"train: {moved} of {n_float} trainable float leaves moved, {kept} frozen and integer "
            f"leaves bitwise as initialised; last.npz (step {meta['step']}) reloads to the trained "
            f"params bitwise: {ckpt_ok} ({load_s:.1f} s)")
        if moved < n_float // 2 or not ckpt_ok or meta["step"] != 1 + steps:
            raise SystemExit("train: the params did not move, or last.npz does not reload to them")

    batch = next(train_batches(from_data_config(config["data"]), BATCH, seed=1))
    batch = {k: torch.from_numpy(batch[k]).to(device) for k in ("images", "poke")}
    flow = run["state"].params["flow"]
    with torch.no_grad():
        x, _ = second_stage.encode_first_stage(trained, spec, batch["images"])
        cond = second_stage.embed_cond(trained, spec, batch["images"][:, 0], batch["poke"])
        z, logdet = transformer.forward(flow, spec.flow, x, cond)
        k1.mcf_inverse.launches = 0
        k2.macow_unit_inverse.launches = 0
        x_back = transformer.reverse(flow, replace(spec.flow, mcf_backend="cuda_unit"), z, cond)
        torch.cuda.synchronize()
        n_rt = (k1.mcf_inverse.launches, k2.macow_unit_inverse.launches)
    err = (x_back - x).abs().max().item()
    log(f"train: round trip on the trained params: max |reverse(forward(x)) - x| {err:.3g} "
        f"(tolerance {TRAIN_TOL}; |x| up to {x.abs().max().item():.3g}, logdet "
        f"{logdet.mean().item():.6g}); K1/K2 launches {n_rt[0]}/{n_rt[1]} (want 0/"
        f"{4 * sum(spec.flow.num_steps)})")
    if not err <= TRAIN_TOL or n_rt != (0, 4 * sum(spec.flow.num_steps)):
        raise SystemExit(f"train: the round trip failed ({err}, K1/K2 launches {n_rt})")
    phase_s = time.perf_counter() - t_phase
    log(f"train: the phase took {phase_s:.1f} s")
    return {"phase_s": phase_s, "init_s": run["init_s"], "save_s": run["save_s"],
            "load_s": load_s, "step_ms_first": step_ms[0], "step_ms_median": median,
            "step_ms": step_ms, "peak_gib": peak, "flow_loss": [h["flow_loss"] for h in hist],
            "grad_norm": [h["grad_norm"] for h in hist], "ckpt_gb": ckpt_gb,
            "roundtrip_max_abs_err": err,
            "launches": {"mcf_inverse": n_step[0], "macow_unit_inverse": n_step[1]},
            "roundtrip_launches": {"mcf_inverse": n_rt[0], "macow_unit_inverse": n_rt[1]}}


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

    entry = registry.MODELS[registry.FLAGSHIP]
    spec = registry.build_specs(entry)
    spec = replace(spec, first_stage=replace(spec.first_stage, decode_dtype="bf16")).validate()
    levels = list(zip(spec.flow.level_channels(), spec.flow.num_steps))
    kernels = phase_kernels(device, card, flagship_levels=levels)

    t0 = time.perf_counter()
    params = synth.synth_params(spec, seed=0, device=device)
    params = dict(params, flow=synth.zero_flow_output_convs(params["flow"]))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in train_ss.leaves(params))
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
    overhead = op_overhead(device, log, card)
    serve = phase_serve(card, spec, params, steady)
    phase_serve_check(device, spec, params)
    t0 = time.perf_counter()
    dist, student = phase_distill(device, card, spec, params, steady)
    log(f"distill: the phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_artifact_") as tmp:
        art = phase_artifact(device, card, spec, params, student, Path(tmp))
    log(f"artifact: the phase took {time.perf_counter() - t0:.1f} s")
    del params
    train = phase_train(device, card, entry)

    src = "ipoke_tpu_torch/csrc/{}.cu"
    rows = [
        dict(name=name, route="cuda", source=src.format(source), replaces=replaces,
             launches=res["launches"][name], serve_launches=serve["launches"][name],
             distill_direct_step_launches=dist["direct"]["launches_per_step"][name],
             distill_flow_roundtrip_launches=dist["flow"]["roundtrip_launches"][name],
             artifact_flow_call_launches=art["flow"]["launches_per_call"][name],
             artifact_student_serve_launches=art["student"]["launches"][name],
             train_step_launches=train["launches"][name],
             train_roundtrip_launches=train["roundtrip_launches"][name],
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
    print(json.dumps({"train": train}), flush=True)
    print(json.dumps({"distill": dist, "artifact": art, "op_overhead": overhead}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
