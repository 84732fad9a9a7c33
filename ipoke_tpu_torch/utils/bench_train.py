"""Stage-2 flow train step at a registry model's width on the CUDA card (the
port's counterpart of ``ipoke_tpu/utils/bench_train.py``).

    python -m ipoke_tpu_torch.utils.bench_train [--batch 8] [--iters 5] \\
        [--model iper_128] [--per-level [--opt adamw|adafactor] | --chunked] \\
        [--levels N] [--remat | --no-remat] [--dtype f32|bf16] [--converge N]

Params from the port's ``init`` (JAX's draw at key 0), the flow at full
depth unless ``--levels`` keeps the first N levels, each MaCowStep
checkpointed (``FlowSpec.remat``, on by default as in JAX).  The step is
``make_train_step`` with ``make_optimizer(lr=1e-3)`` (``--dtype bf16``: its
``compute_dtype``); ``--per-level``: ``train/chunked.make_per_level_trainer``
with a fresh optimizer per level, ``make_optimizer(lr=1e-3)`` or, with
``--opt adafactor``, ``adafactor(1e-3)``; ``--chunked``: the one-graph step
on the flow alone with JAX's chunked metrics.  The batch is JAX's normal
draws from keys 1 and 2, the step keys ``fold_in`` of key 3.  ``--converge
N`` then runs N steps on fresh batches drawn on the card from
``fold_in(prng_key(11), i)`` and reports the loss curve.

Prints JAX's one JSON line (the same keys), with the peak
``max_memory_allocated``, the card's name and power limit and the init
seconds beside; every time is host time to a synchronised card.
``--device cpu`` runs it on the CPU, only when asked.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from dataclasses import replace

import torch

from ipoke_tpu_torch import registry, resolve_device
from ipoke_tpu_torch.experiments.second_stage import CHUNKED_METRICS
from ipoke_tpu_torch.models import second_stage
from ipoke_tpu_torch.train import chunked
from ipoke_tpu_torch.train import second_stage as train_ss
from ipoke_tpu_torch.utils import prng


def converge_batch(i, b, t, s, device):
    """The --converge batch of step i: JAX's ``make_batch(fold_in(
    PRNGKey(11), i))``."""
    k1, k2 = prng.split(prng.fold_in(prng.prng_key(11), i))
    return {"images": prng.normal(k1, (b, t, s, s, 3), device),
            "poke": prng.normal(k2, (b, s, s, 2), device)}


def build_step(args, spec, params):
    """(step, state) of the trainer the flags select."""
    trainable, frozen = train_ss.split_params(params)
    if args.per_level:
        def make_opt(level_params):
            if args.opt == "adafactor":
                return train_ss.adafactor(1e-3)
            return train_ss.make_optimizer(lr=1e-3)

        step = chunked.make_per_level_trainer(spec.flow, spec, frozen, make_opt)
        return step, step.init_state(trainable["flow"])
    if args.chunked:
        frozen.update({k: v for k, v in trainable.items() if k != "flow"})
        trainable = {"flow": trainable["flow"]}
    opt = train_ss.make_optimizer(lr=1e-3)
    compute_dtype = torch.bfloat16 if args.dtype == "bf16" else None
    step = train_ss.make_train_step(spec, frozen, opt, compute_dtype=compute_dtype)
    if args.chunked:
        one_graph = step

        def step(state, batch, rng):
            state, metrics = one_graph(state, batch, rng)
            return state, {k: metrics[k] for k in CHUNKED_METRICS}

    return step, train_ss.init_state(trainable, opt)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ipoke_tpu_torch.utils.bench_train")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--model", default=registry.FLAGSHIP)
    ap.add_argument("--opt", default="adamw", choices=["adamw", "adafactor"],
                    help="the per-level trainer's optimizer (make_optimizer or adafactor)")
    ap.add_argument("--per-level", dest="per_level", action="store_true",
                    help="train/chunked.make_per_level_trainer: each level updated after its "
                         "backward")
    ap.add_argument("--chunked", action="store_true",
                    help="the one-graph step on the flow alone, with JAX's chunked metrics")
    ap.add_argument("--levels", type=int, default=0,
                    help="keep the first N flow levels (0 = all)")
    ap.add_argument("--remat", action="store_true", default=True)
    ap.add_argument("--no-remat", dest="remat", action="store_false")
    ap.add_argument("--dtype", default="f32", choices=["f32", "bf16"],
                    help="bf16: the forward in bf16 on casts of the f32 params (monolithic "
                         "trainer only)")
    ap.add_argument("--converge", type=int, default=0,
                    help="after the timed steps, N steps on fresh batches drawn on the device")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' only when asked)")
    args = ap.parse_args(argv)
    if args.per_level and args.chunked:
        ap.error("--per-level and --chunked are two trainers; pick one")
    if args.dtype == "bf16" and (args.per_level or args.chunked):
        ap.error("--dtype bf16 is the monolithic trainer's (make_train_step's compute_dtype)")
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    if cuda:   # f32 convs and matmuls in full f32, as the JAX package computes
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    from ipoke_tpu_torch.utils.kernel_bench import card_line

    def sync():
        if cuda:
            torch.cuda.synchronize()

    spec = registry.build_specs(registry.MODELS[args.model])
    flow = replace(spec.flow, remat=args.remat)
    if args.levels:
        flow = replace(flow, num_steps=flow.num_steps[:args.levels])
    spec = replace(spec, flow=flow)

    t0 = time.perf_counter()
    params = second_stage.init(prng.prng_key(0), spec, device)
    sync()
    init_s = time.perf_counter() - t0
    step, state = build_step(args, spec, params)
    del params

    b, t, s = args.batch, spec.first_stage.max_frames, spec.first_stage.spatial_size
    batch = {"images": prng.normal(prng.prng_key(1), (b, t, s, s, 3), device),
             "poke": prng.normal(prng.prng_key(2), (b, s, s, 2), device)}
    rng = prng.prng_key(3)

    def timed(batch, key):
        nonlocal state
        sync()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, key)
        loss = float(metrics["flow_loss"])
        sync()
        return time.perf_counter() - t0, loss

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    first_s, loss = timed(batch, rng)
    times = []
    for i in range(args.iters):
        rng = prng.fold_in(rng, i)
        dt, loss = timed(batch, rng)
        times.append(dt)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30 if cuda else None

    converge = {}
    if args.converge:
        curve = []
        t0 = time.perf_counter()
        for i in range(args.converge):
            _, loss = timed(converge_batch(i, b, t, s, device), prng.fold_in(rng, 1000 + i))
            if i % 10 == 0 or i == args.converge - 1:
                curve.append((i, loss))
        wall = time.perf_counter() - t0
        losses = [x for _, x in curve]
        converge = {
            "converge_steps": args.converge,
            "converge_wall_s": round(wall, 1),
            "loss_first": round(losses[0], 3),
            "loss_last": round(losses[-1], 3),
            "loss_min": round(min(losses), 3),
            "curve_every10": [(i, round(x, 2)) for i, x in curve[::max(1, len(curve) // 20)]],
        }

    best = statistics.median(times) if times else first_s
    print(json.dumps({
        **converge,
        "train_step_s": round(best, 4),
        "examples_per_s": round(b / best, 2),
        "all_steps_s": [round(x, 4) for x in times],
        "compile_plus_first_s": round(first_s, 1),
        "loss": loss,
        "batch": b,
        "model": args.model,
        "remat": args.remat,
        "chunked": args.chunked,
        "per_level": args.per_level,
        "opt": args.opt,
        "dtype": args.dtype,
        "levels": args.levels or len(spec.flow.num_steps),
        "n_flow_steps": int(sum(spec.flow.num_steps)),
        "peak_gib": peak_gib,
        "init_s": init_s,
        "device": card_line() if cuda else str(device),
    }), flush=True)


if __name__ == "__main__":
    main()
