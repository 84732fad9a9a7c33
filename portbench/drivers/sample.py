"""Sampling traffic: ``models/second_stage.forward_sample`` calls back to
back, each on fresh start images, pokes and Gaussian draws from the seed.

Set-up makes the weights and warms up with calls of the cell's own shape.
The window counts the videos of every call it issued and ends in a device
synchronise.  A traced run then profiles ``trace_calls`` more calls.  Once
the windows have closed, ``check_calls`` of the window's calls, drawn from
the seed, are recomputed by the frozen reference from the same inputs and
compared video by video.
"""
from __future__ import annotations

import random
import time

import torch

from portbench import flops, inputs, roofline, trace, weights
from portbench.port import port_spec
from portbench.clock import Window
from portbench.reference import sample as ref
from portbench.reference.sample import level_channels
from portbench.result import Outcome


def call_inputs(ctx, i):
    """(images (B,1,S,S,3), pokes (B,S,S,2), z (n,B,s,s,C)) of call ``i``."""
    cfg, t, dev = ctx.config, ctx.traffic, ctx.device
    fs = cfg["first_stage"]
    g = inputs.generator(dev, ctx.seed, "call", i)
    b, size = t["start_images"], fs["spatial_size"]
    images = inputs.start_frames(g, b, size, dev)[:, None]
    pokes = inputs.sparse_pokes(g, b, size, dev, t["poke_size"], t["n_pokes"], t["poke_scale"])
    z = inputs.gaussian_z(g, t["n_samples"], b, fs["min_spatial_size"], fs["z_dim"], dev)
    return images, pokes, z


def make_params(ctx):
    a = ctx.config["assumed"]
    return weights.make(weights.second_stage_tree(ctx.config),
                        inputs.generator(ctx.device, ctx.seed, "weights"), ctx.device,
                        a["weight_std"], a["flow_output_gain"])


def check(ctx, params, kept, limit, sync):
    """Recompute each kept call with the reference; (largest |port - reference|
    over all videos, videos over ``limit``).  A video that is not finite on
    either side reads infinity."""
    t = ctx.traffic
    worst, failed = 0.0, 0
    for i, videos in kept:
        images, pokes, z = call_inputs(ctx, i)
        want = ref.forward_sample(params, ctx.config, images, pokes, z, t["frames"] - 1)
        err = (videos - want).abs().flatten(2).amax(dim=2)        # (n, B): one per video
        err = torch.where(torch.isfinite(err), err, torch.full_like(err, float("inf")))
        failed += int((err > limit).sum())
        worst = max(worst, float(err.max()))
        if not bool(torch.isfinite(want).all() and torch.isfinite(videos).all()):
            ctx.log(f"sample: call {i}: videos not finite: port "
                    f"{int((~torch.isfinite(videos)).flatten(2).any(2).sum())}, reference "
                    f"{int((~torch.isfinite(want)).flatten(2).any(2).sum())} of {err.numel()}")
        sync()
    return worst, failed


def run(ctx):
    from ipoke_tpu_torch.models import second_stage
    dev, t, cfg = ctx.device, ctx.traffic, ctx.config
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    spec = port_spec(cfg)
    params = make_params(ctx)
    videos_per_call = t["start_images"] * t["n_samples"]

    def call(i):
        images, pokes, z = call_inputs(ctx, i)
        return second_stage.forward_sample(params, spec, {"images": images, "poke": pokes}, z=z,
                                           length=t["frames"] - 1)

    for w in range(t["warmup_calls"]):
        call(-1 - w)
    sync()
    setup_s = time.perf_counter() - ctx.t_start
    ctx.log(f"sample: set-up {setup_s:.3f} s; {weights.count(weights.second_stage_tree(cfg))} "
            f"params; {videos_per_call} videos per call")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    # the checked calls: a uniform sample of the window's calls, drawn from the seed
    draw = random.Random(inputs.stream(ctx.seed, "check"))
    kept = []

    def unit(i):
        out = call(i)
        if len(kept) < t["check_calls"]:
            kept.append((i, out))
        else:
            j = draw.randrange(i + 1)
            if j < t["check_calls"]:
                kept[j] = (i, out)

    window = Window(ctx.seconds, sync)
    elapsed = window.run(unit)
    calls = window.units
    ctx.log(f"sample: {calls} calls of {videos_per_call} videos in {elapsed:.4f} s")
    readings, breakdown = {}, None
    if ctx.trace:
        summary = trace.traced(lambda: [call(calls + k) for k in range(t["trace_calls"])], sync)
        fs = cfg["first_stage"]
        hc = cfg["poke_embedder"]["nf_max"] + cfg["conditioner"]["nf_max"]
        least = roofline.mcf_least_ms(videos_per_call, fs["min_spatial_size"], hc,
                                      level_channels(cfg), cfg["flow"]["num_steps"]) / 1e3
        readings = dict(summary, kind="sample", units=t["trace_calls"],
                        videos=t["trace_calls"] * videos_per_call,
                        mcf_least_s=least * t["trace_calls"],
                        mcf_kernel_s=trace.kernel_seconds(summary,
                                                          (roofline.K1_KERNEL, roofline.K2_KERNEL)),
                        unit_s=elapsed / calls,
                        unit_flops=flops.sample_call(cfg, t["start_images"], t["n_samples"],
                                                     t["frames"] - 1))
        breakdown = {"device_ops": summary["top_ops"], "idle_gaps": summary["idle_gaps"]}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    limit = ctx.cell["limits"]["video_max_abs"]
    t0 = time.perf_counter()
    worst, failed = check(ctx, params, kept, limit, sync)
    ctx.log(f"sample: the reference took {time.perf_counter() - t0:.3f} s")
    ctx.log(f"sample: checked calls {sorted(i for i, _ in kept)}: largest |port - reference| "
            f"{worst!r}; {failed} videos over {limit}")
    return Outcome(calls * videos_per_call, failed,
                   {"videos_per_s": videos_per_call * calls / elapsed, "setup_s": setup_s},
                   readings, {"video_max_abs": (worst, limit)}, peak, breakdown)

