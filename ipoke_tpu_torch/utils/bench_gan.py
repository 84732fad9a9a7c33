"""Stage-1 cVAE-GAN train step on the CUDA card (the port's counterpart of
``ipoke_tpu/utils/bench_gan.py``).

    python -m ipoke_tpu_torch.utils.bench_gan [--model iper_128] [--batch 8] \
        [--iters 5] [--remat-mode none|outer|decode|both] [--vgg-chunks N] \
        [--disc-bf16] [--n-spatial 16] [--converge N]

One step is the temporal-disc update (hinge + the gradient penalty's double
backward), the spatial-disc update, and the generator update (adversarial +
feature maps + VGG19 + L1 + KL), at the registry model's first-stage width
(iper_128: 10 frames of 128x128), from JAX's init at seed 0 on a batch of
``0.5 * normal`` frames.  Prints, with the card's name and power limit:
  * the first step and the median of ``--iters`` steps after it, each host
    time to a synchronised device, and the peak ``max_memory_allocated``;
  * the split of each timed step into the dt, ds and generator updates by
    CUDA events, medians, and the temporal disc's loss and gradients with
    and without the gradient penalty (its double backward);
  * one more step in a ``torch.profiler`` window: device busy time, device
    kernels and copies launched, and device time by kernel name;
  * with ``--converge N``, N more steps on a learnable video distribution
    drawn on the card (``blob_videos``: a coloured Gaussian blob drifting at
    a constant velocity over a tinted background, JAX's draws from
    ``fold_in(prng_key(21), i)``; step keys ``fold_in(prng_key(2), 5000 +
    i)``), and JAX's curve of the reconstruction, KL and disc losses;
  * one JSON line with these numbers.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from dataclasses import replace

import torch
from torch.profiler import ProfilerActivity, profile

from ipoke_tpu_torch import registry
from ipoke_tpu_torch.models.discriminators import PatchDiscSpec, TempDiscSpec
from ipoke_tpu_torch.train import first_stage as tfs
from ipoke_tpu_torch.utils import prng
from ipoke_tpu_torch.utils.profile_sample import TOP, _card, _device_us, _on_device

PHASES = ("dt", "ds", "gen")
CONVERGE_TRACK = ("l_rec", "l_vgg", "l_kl", "loss", "loss_d_dt", "loss_d_ds")


def blob_videos(i, b, t, ss, device):
    """The --converge batch of step i: JAX's ``make_videos(fold_in(
    PRNGKey(21), i))``, (b, t, ss, ss, 3) in [-1, 1]."""
    ks = prng.split(prng.fold_in(prng.prng_key(21), i), 6)
    c0 = prng.uniform(ks[0], (b, 2), 0.25, 0.75, device)
    vel = prng.uniform(ks[1], (b, 2), -0.03, 0.03, device)
    color = prng.uniform(ks[2], (b, 3), 0.3, 1.0, device)
    tint = prng.uniform(ks[3], (b, 3), -0.6, 0.0, device)
    sign = torch.sign(prng.normal(ks[4], (b, 3), device))
    grid = torch.linspace(0.0, 1.0, ss, device=device)
    gy, gx = torch.meshgrid(grid, grid, indexing="ij")
    steps = torch.arange(t, dtype=torch.float32, device=device)[None, :, None]
    ctr = c0[:, None, :] + vel[:, None, :] * steps                      # (B, T, 2)
    d2 = (gy[None, None] - ctr[..., 0:1, None]) ** 2 + (gx[None, None] - ctr[..., 1:2, None]) ** 2
    blob = torch.exp(-d2 / (2 * 0.008))
    vids = (tint[:, None, None, None, :]
            + sign[:, None, None, None, :] * color[:, None, None, None, :] * blob[..., None])
    return {"images": torch.clamp(vids, -1.0, 1.0)}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ipoke_tpu_torch.utils.bench_gan")
    ap.add_argument("--model", default=registry.FLAGSHIP)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--remat-mode", default="none", choices=list(tfs.REMAT_MODES))
    ap.add_argument("--vgg-chunks", type=int, default=1,
                    help="the perceptual loss over N equal frame chunks, each checkpointed; "
                         "must divide batch * (frames - 1)")
    ap.add_argument("--disc-bf16", action="store_true")
    ap.add_argument("--n-spatial", type=int, default=16)
    ap.add_argument("--converge", type=int, default=0,
                    help="after the timed steps, N steps on blob videos drawn on the card, "
                         "with the loss curves")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_gan: ipoke_tpu_torch: no CUDA device; this benchmark needs the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = _card()

    fs_spec = registry.build_specs(registry.MODELS[args.model]).first_stage
    ss, t, b = fs_spec.spatial_size, fs_spec.max_frames, args.batch
    dt_spec = TempDiscSpec(spatial_size=ss, sequence_length=min(12, t), gp_weight=1.0)
    ds_spec = PatchDiscSpec(gp_weight=0.0)
    t0 = time.perf_counter()
    state, opts = tfs.init_gan_state(prng.prng_key(0), fs_spec, ds_spec, dt_spec, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = tfs.make_gan_train_step(fs_spec, ds_spec, dt_spec, opts, n_spatial_examples=args.n_spatial,
                                   remat=args.remat_mode, vgg_chunks=args.vgg_chunks,
                                   disc_bf16=args.disc_bf16)
    batch = {"images": 0.5 * prng.normal(prng.prng_key(1), (b, t, ss, ss, 3), dev)}
    rng = prng.prng_key(2)

    def one(i, on_phase=lambda name: None):
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, prng.fold_in(rng, i), on_phase)
        metrics = {k: float(v) for k, v in metrics.items()}
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, metrics

    torch.cuda.reset_peak_memory_stats()
    first_ms, _ = one(0)
    step_ms, split = [], {p: [] for p in PHASES}
    for i in range(1, 1 + args.iters):
        events = [torch.cuda.Event(enable_timing=True)]
        events[0].record()

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)

        ms, metrics = one(i, mark)
        step_ms.append(ms)
        for p, a, z in zip(PHASES, events, events[1:]):
            split[p].append(a.elapsed_time(z))
    peak = torch.cuda.max_memory_allocated() / 2**30
    median = statistics.median(step_ms)
    split_med = {p: statistics.median(v) for p, v in split.items()}
    label = (f"{args.model} B={b}, {t} frames of {ss}^2, remat={args.remat_mode}, "
             f"vgg_chunks={args.vgg_chunks}, disc_bf16={args.disc_bf16}")
    print(f"[{card}] stage-1 GAN step, {label}: init {init_s:.2f} s; first step {first_ms:.1f} ms; "
          f"steps {', '.join(f'{x:.1f}' for x in step_ms)} ms (median {median:.1f}); split by CUDA "
          f"events (median) dt {split_med['dt']:.1f}, ds {split_med['ds']:.1f}, generator "
          f"{split_med['gen']:.1f} ms; peak {peak:.2f} GiB", flush=True)

    # the gradient penalty's share of the dt update: the temporal disc's loss
    # and gradients with the penalty and without it, on a real and a fake crop
    x_true = batch["images"][:, :dt_spec.sequence_length]
    x_fake = 0.5 * prng.normal(prng.prng_key(3), tuple(x_true.shape), dev)
    leaves = tfs.float_leaves(tfs.trainable(state.dt_params))
    gp_ms = {}
    for name, spec in (("with_gp", dt_spec), ("without_gp", replace(dt_spec, gp_weight=0.0))):
        losses = tfs.GanLosses(fs_spec, ds_spec, spec, vgg=step.losses.vgg)

        def dt_grads():
            loss, _ = losses.disc_loss("dt", state.dt_params, x_true, x_fake)
            torch.autograd.grad(loss, leaves)

        dt_grads()
        ms = []
        for _ in range(3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            dt_grads()
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        gp_ms[name] = statistics.median(ms)
    print(f"[{card}] temporal disc loss and gradients (CUDA events, median of 3): with the "
          f"gradient penalty {gp_ms['with_gp']:.1f} ms, without {gp_ms['without_gp']:.1f} ms",
          flush=True)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        step(state, batch, prng.fold_in(rng, 1 + args.iters))
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, _device_us(e) / 1e3, e.count) for e in prof.key_averages()
                   if _on_device(e)), key=lambda r: -r[1])
    busy, launches = sum(r[1] for r in rows), sum(r[2] for r in rows)
    print(f"[{card}] profiled step: {prof_ms:.1f} ms on the host, device busy {busy:.1f} ms "
          f"({100 * busy / prof_ms:.1f}%), {launches} device kernels/copies", flush=True)
    for n, ms, c in rows[:TOP]:
        print(f"  {ms:9.3f} ms  {100 * ms / max(busy, 1e-9):5.1f}%  x{c:<6d} {n[:100]}")
    converge = {}
    if args.converge:
        curve = []
        t0 = time.perf_counter()
        for i in range(args.converge):
            state, m = step(state, blob_videos(i, b, t, ss, dev), prng.fold_in(rng, 5000 + i))
            if i % 10 == 0 or i == args.converge - 1:
                curve.append((i, {k: float(m[k]) for k in CONVERGE_TRACK}))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        recs = [c["l_rec"] for _, c in curve]
        converge = {
            "converge_steps": args.converge,
            "converge_wall_s": round(wall, 1),
            "l_rec_first": round(recs[0], 4),
            "l_rec_last": round(recs[-1], 4),
            "l_rec_min": round(min(recs), 4),
            "curve_every10": [(i, {k: round(v, 3) for k, v in c.items()})
                              for i, c in curve[::max(1, len(curve) // 15)]],
        }
        print(f"[{card}] converge: {args.converge} steps on blob videos in {wall:.1f} s, l_rec "
              f"{converge['l_rec_first']} -> {converge['l_rec_last']} (min "
              f"{converge['l_rec_min']})", flush=True)
    print(json.dumps({
        **converge,
        "metric": f"stage-1 GAN train step, {label}", "card": card, "init_s": init_s,
        "first_step_ms": first_ms, "median_step_ms": median, "step_ms": step_ms,
        "split_ms": split_med, "dt_grads_ms": gp_ms, "peak_gib": peak, "examples_per_s": b / median * 1e3,
        "launches_per_step": launches, "profiled_host_ms": prof_ms, "device_busy_ms": busy,
        "top": [{"name": n[:120], "ms": ms, "count": c} for n, ms, c in rows[:TOP]],
        "final_metrics": metrics}), flush=True)


if __name__ == "__main__":
    main()
