"""Stage-1 training traffic: ``train/first_stage.make_gan_train_step`` steps
back to back, each on a fresh batch of seeded videos and its own JAX key.

Set-up builds the one train state from the benchmark's weights and drives
it through its first ``checked_steps`` steps (they warm up every shape),
recording each step's losses, the first gradient as Adam holds it after
one step, and each leaf's change after the last of them.  The window goes on
from there with the same state.  Once it has closed and the port's state is
freed, the frozen reference repeats those steps from the same weights,
batches and keys, and the readings are compared leaf by leaf.
"""
from __future__ import annotations

import copy
import math
import statistics
import time

import torch

from portbench import flops, inputs, trace, weights
from portbench.clock import Window
from portbench.port import port_spec
from portbench.reference import gan as ref
from portbench.reference import prng
from portbench.result import Outcome

LOSSES = ("loss_d_dt", "loss_d_ds", "loss")


def batch(ctx, i):
    t, fs = ctx.traffic, ctx.config["first_stage"]
    g = inputs.generator(ctx.device, ctx.seed, "batch", i)
    return inputs.blob_videos(g, t["batch"], t["frames"], fs["spatial_size"], ctx.device)


def key(ctx, i):
    return prng.fold_in(prng.prng_key(ctx.seed & prng.MASK), i)


def make_nets(ctx):
    return weights.make(weights.gan_trees(ctx.config),
                        inputs.generator(ctx.device, ctx.seed, "weights"), ctx.device,
                        ctx.config["assumed"]["weight_std"], None)


def port_step(ctx, nets):
    """(state, step) of the port on ``nets``, which it then owns."""
    from ipoke_tpu_torch.models.discriminators import PatchDiscSpec, TempDiscSpec
    from ipoke_tpu_torch.train import first_stage as tfs
    from ipoke_tpu_torch.train.second_stage import float_leaves
    t, a = ctx.traffic, ctx.traffic["adam"]
    fs_spec = port_spec(ctx.config).first_stage
    dt_spec = TempDiscSpec(spatial_size=fs_spec.spatial_size, sequence_length=t["mf_dt"],
                           gp_weight=t["gp_weight_dt"])
    ds_spec = PatchDiscSpec(gp_weight=0.0)
    opts = {n: tfs.make_gan_optimizer(a["lr"], a["weight_decay"], a["gamma"], a["steps_per_epoch"])
            for n in ref.NETS}
    for n in ref.NETS:
        for leaf in float_leaves(tfs.trainable(nets[n])):
            leaf.requires_grad_(True)
    state = tfs.GanTrainState(0, nets["gen"], nets["ds"], nets["dt"],
                              *(opts[n].init(tfs.trainable(nets[n])) for n in ref.NETS))
    step = tfs.make_gan_train_step(fs_spec, ds_spec, dt_spec, opts, w_vgg=t["w_vgg"], w_l1=t["w_l1"],
                                   w_kl=t["w_kl"], n_spatial_examples=t["n_spatial"])
    if step.losses.vgg.pretrained:
        raise RuntimeError("portbench: the port loaded pretrained VGG19 filters; the reference "
                           "holds the seeded ones")
    return state, step


def trained(tree):
    return [p for p in ref.leaves(ref.trainable(tree)) if p.is_floating_point()]


def adam_first(opt_state, b1):
    """The gradient Adam was given at its first step: its first moment over (1 - b1)."""
    (mu,) = [s["mu"] for s in opt_state if isinstance(s, dict) and "mu" in s]
    return [float(torch.linalg.vector_norm(m)) / (1 - b1) for m in mu]


def norms_of_change(tree, start):
    return [float(torch.linalg.vector_norm(p.detach() - p0)) for p, p0 in zip(trained(tree), start)]


def _gap(a, b, scale):
    """|a - b| / scale, infinite where either side is not finite."""
    gap = abs(a - b) / scale
    return gap if math.isfinite(gap) else math.inf


def leaf_gap(prog, want, keep=None):
    """The worst leaf's gap between two lists of norms, over the larger of
    that leaf's reference norm and the median leaf's."""
    med = statistics.median(want)
    gaps = [_gap(p, w, max(w, med)) for i, (p, w) in enumerate(zip(prog, want))
            if keep is None or keep[i]]
    return max(gaps) if gaps else 0.0


def _loss_gap(p, w):
    return max(_gap(p[k], w[k], max(abs(w[k]), 1e-12)) for k in LOSSES)


def compare(prog, want, rule):
    """The numbers compared, each a relative gap between the port and the
    reference: the first step's three losses; the first gradient's norm per
    leaf of the two discriminators (updated first, from the same weights)
    and of the generator (updated after them, so its gradient already holds
    the noise of their first Adam step); the change's norm per leaf after
    the checked steps, leaves whose reference gradient is under ``rule`` of
    the median leaf's left out.  ``loss_gap.later`` (the later steps'
    losses) is returned for the log and not compared."""
    grads = {n: leaf_gap(prog["grads"][n], want["grads"][n]) for n in ref.NETS}
    change_gap = 0.0
    for n in ref.NETS:
        med = statistics.median(want["grads"][n])
        keep = [g >= rule * med for g in want["grads"][n]]
        change_gap = max(change_gap, leaf_gap(prog["changes"][n], want["changes"][n], keep))
    return {"loss_gap": _loss_gap(prog["losses"][0], want["losses"][0]),
            "grad_gap.disc": max(grads["dt"], grads["ds"]), "grad_gap.gen": grads["gen"],
            "change_gap": change_gap,
            "loss_gap.later": max(_loss_gap(p, w) for p, w in zip(prog["losses"][1:], want["losses"][1:]))}


def reference_readings(ctx, start_nets):
    """The reference's losses, first gradients and changes over the checked steps."""
    t = ctx.traffic
    nets = copy.deepcopy(start_nets)
    start = {n: trained(start_nets[n]) for n in ref.NETS}
    step = ref.GanStep(nets, ctx.config["first_stage"], t, ctx.device)
    losses, grads = [], {}
    for i in range(t["checked_steps"]):
        out = step(batch(ctx, i), key(ctx, i))
        losses.append({k: float(v) for k, v in out.items()})
        if i == 0:
            b1 = t["adam"]["b1"]
            grads = {n: [float(torch.linalg.vector_norm(m)) / (1 - b1) for m in step.opts[n].mu]
                     for n in ref.NETS}
    changes = {n: norms_of_change(nets[n], start[n]) for n in ref.NETS}
    return {"losses": losses, "grads": grads, "changes": changes}


def checked_steps(ctx, state, step, start):
    """The port's first steps from ``start``: (state, their readings)."""
    t = ctx.traffic
    losses, grads = [], {}
    for i in range(t["checked_steps"]):
        state, m = step(state, {"images": batch(ctx, i)}, key(ctx, i))
        losses.append({k: float(m[k]) for k in LOSSES})
        if i == 0:
            grads = {n: adam_first(getattr(state, f"{n}_opt"), t["adam"]["b1"]) for n in ref.NETS}
    changes = {n: norms_of_change(getattr(state, f"{n}_params"), start[n]) for n in ref.NETS}
    return state, {"losses": losses, "grads": grads, "changes": changes}


def _median_ms(marks, a, b):
    if not all(a in e and b in e for e in marks):
        return None
    return statistics.median(e[a].elapsed_time(e[b]) for e in marks)


def run(ctx):
    dev, t, cfg = ctx.device, ctx.traffic, ctx.config
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    nets = make_nets(ctx)
    start_nets = {n: copy.deepcopy(nets[n]) for n in ref.NETS}   # the reference's copy
    start = {n: trained(start_nets[n]) for n in ref.NETS}
    state, step = port_step(ctx, nets)

    state, prog = checked_steps(ctx, state, step, start)
    sync()
    setup_s = time.perf_counter() - ctx.t_start
    ctx.log(f"gan: set-up {setup_s:.3f} s, {t['checked_steps']} steps in it; losses {prog['losses']}")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    first = t["checked_steps"]

    def unit(i):
        nonlocal state
        state, _ = step(state, {"images": batch(ctx, first + i)}, key(ctx, first + i))

    window = Window(ctx.seconds, sync)
    elapsed = window.run(unit)
    steps = window.units
    ctx.log(f"gan: {steps} steps in {elapsed:.4f} s")
    readings, breakdown = {}, None
    if ctx.trace:
        base, marks = first + steps, []

        def traced_steps():
            nonlocal state
            for k in range(t["trace_steps"]):
                ev = {}

                def mark(name, ev=ev):   # device time at the step's phase boundaries
                    if dev.type == "cuda":
                        ev[name] = torch.cuda.Event(enable_timing=True)
                        ev[name].record()

                mark("start")
                state, _ = step(state, {"images": batch(ctx, base + k)}, key(ctx, base + k), mark)
                marks.append(ev)

        summary = trace.traced(traced_steps, sync)
        readings = dict(summary, kind="train", units=t["trace_steps"], unit_s=elapsed / steps,
                        unit_flops=flops.gan_step(cfg, t),
                        disc_ms=_median_ms(marks, "start", "ds"), gen_ms=_median_ms(marks, "ds", "gen"))
        breakdown = {"device_ops": summary["top_ops"], "idle_gaps": summary["idle_gaps"]}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del state, step, nets
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    want = reference_readings(ctx, start_nets)
    limits = ctx.cell["limits"]
    got = compare(prog, want, ctx.cell["leaf_rule"])
    ctx.log(f"gan: not compared: loss_gap.later {got.pop('loss_gap.later')!r}")
    checks = {k: (v, limits[k]) for k, v in got.items()}
    ctx.log(f"gan: reference losses {want['losses']}")
    for what in ("grads", "changes"):
        for n in ref.NETS:
            p_, w_ = prog[what][n], want[what][n]
            med = statistics.median(w_)
            worst = sorted(range(len(w_)), key=lambda i: -abs(p_[i] - w_[i]) / max(w_[i], med))[:3]
            ctx.log(f"gan: {what} {n}: median leaf {med:.4g}; worst leaves "
                    + ", ".join(f"#{i} port {p_[i]:.6g} reference {w_[i]:.6g}" for i in worst))
    failed = sum(v > lim for v, lim in checks.values())
    return Outcome(steps, failed, {"train_step_ms": elapsed * 1e3 / steps, "setup_s": setup_s},
                   readings, checks, peak, breakdown)
