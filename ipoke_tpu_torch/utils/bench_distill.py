"""Distillation at a registry model's full width on the card (counterpart of
``ipoke_tpu/utils/bench_distill.py``), against a synthesised teacher.

    # step benchmark
    python -m ipoke_tpu_torch.utils.bench_distill --student direct --steps 8
    # train, evaluate on held-out conditionings, save the student
    python -m ipoke_tpu_torch.utils.bench_distill --student direct --steps 3000 \\
        --cond-pool 64 --eval-batches 4 --save logs/distill/student_direct.npz

The distill step (the frozen teacher's reverse, 200 K2 launches at
iper_128, then the student's update) runs at the shipping width.  The
teacher is ``--init synth-stable`` by default: the port's ``synth_params``
with the flow's output convs zeroed (``zero_flow_output_convs``), a
near-identity flow with a stable reverse; ``synth`` keeps them (timing only:
random flow weights amplify through the reverse), ``init`` is the port's
``init`` (JAX's draw) at key 0.  The student starts from JAX's init at key 0
and trains with optax's ``adam``.  The conditioning is one embedded batch,
or a pool of ``--cond-pool`` batches cycled per step; the held-out
evaluation draws fresh conditionings and z and reports, for a direct
student, motion MSE and relative error, per-channel moment match and the
decoded videos' MSE and PSNR to the teacher's; for a flow student, the
held-out NLL against the teacher's own and the moment match (JAX's FVD*
comparison waits for the metrics, ROADMAP queue 1 item 6).  Prints one JSON
line; progress goes to stderr.  Every time is the card's, with its name and
power limit in the JSON line.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

T0 = time.time()


def log(msg):
    print(f"[bench_distill +{time.time() - T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ipoke_tpu_torch.utils.bench_distill")
    ap.add_argument("--model", default="iper_128")
    ap.add_argument("--student", default="direct", choices=["direct", "flow"])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--student-hidden", type=int, default=256)
    ap.add_argument("--student-depth", type=int, default=6)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--cond-pool", type=int, default=0,
                    help="N embedded (x0, poke) batches cycled during training "
                         "(0: one fixed cond)")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="evaluate on held-out conds every N steps (0: only at the end "
                         "when --eval-batches > 0)")
    ap.add_argument("--eval-batches", type=int, default=0,
                    help="held-out evaluation over N fresh cond batches and fresh z")
    ap.add_argument("--save", default=None, help="write the trained student (ckpt/io npz) here")
    ap.add_argument("--budget-s", type=float, default=0,
                    help="stop training when exceeded (evaluation and save still run)")
    ap.add_argument("--init", default="synth-stable", choices=["init", "synth", "synth-stable"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' only when asked)")
    args = ap.parse_args(argv)

    from ipoke_tpu_torch import registry, resolve_device
    from ipoke_tpu_torch.flows import transformer
    from ipoke_tpu_torch.flows.loss import flow_loss
    from ipoke_tpu_torch.models import second_stage
    from ipoke_tpu_torch.train import distill
    from ipoke_tpu_torch.train.second_stage import adam
    from ipoke_tpu_torch.utils import prng
    from ipoke_tpu_torch.utils.kernel_bench import card_line
    from ipoke_tpu_torch.utils.synth import synth_params, zero_flow_output_convs

    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:   # f32 convs and matmuls in full f32, as the JAX package computes
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    entry = registry.MODELS[args.model]
    spec = registry.build_specs(entry)
    if args.init == "init":
        teacher = second_stage.init(prng.prng_key(0), spec, device)
    else:
        teacher = synth_params(spec, device=device)
        if args.init == "synth-stable":
            teacher["flow"] = zero_flow_output_convs(teacher["flow"])

    if args.student == "direct":
        student = distill.DirectStudentSpec(hidden=args.student_hidden, depth=args.student_depth)
    else:   # one MaCowStep per level
        student = distill.flow_student_spec(spec.flow, (1,) * len(spec.flow.num_steps))
    init_state, step = distill.make_distill_step(spec, student, adam(args.lr))
    state = init_state(prng.prng_key(0), device)

    b, s = args.batch, entry.spatial_size

    def make_cond(seed):
        kx = prng.prng_key(seed)
        x0 = prng.normal(kx, (b, s, s, 3), device)
        poke = prng.normal(prng.fold_in(kx, 1), (b, s, s, 2), device)
        return x0, poke, second_stage.embed_cond(teacher, spec, x0, poke)

    zshape = transformer.reverse_input_shape(spec.flow, b, spec.latent_size, spec.flow_in_channels)
    log(f"embedding the cond pool of {args.cond_pool}" if args.cond_pool else "embedding one cond")
    pool = [make_cond(10_000 + i)[2] for i in range(max(1, args.cond_pool))]

    def decode(m, x0):
        with torch.no_grad():
            return second_stage.decode_first_stage(teacher, spec, m, x0, entry.max_frames - 1).float()

    def moments(mt, ms):   # per-channel moments over (batch, pixels)
        ax = (0, 1, 2)
        return (float(np.max(np.abs(mt.mean(ax) - ms.mean(ax)))),
                float(np.max(np.abs(mt.std(ax) - ms.std(ax)) / (mt.std(ax) + 1e-8))))

    def evaluate(n_batches):
        """Held-out conds (seeds disjoint from the train pool) and fresh z."""
        out = {}
        rows = []
        for j in range(n_batches):
            x0, _, c = make_cond(900_000 + j)
            z = prng.normal(prng.prng_key(800_000 + j), zshape, device)
            mt_t = distill.teacher_motion(teacher, spec, z, c)
            mt = mt_t.float().cpu().numpy()
            with torch.no_grad():
                if args.student == "direct":
                    # fitted to the teacher's map: compare z by z
                    ms_t = distill.direct_apply(state["params"], student, z, c)
                    ms = ms_t.float().cpu().numpy()
                    vt, vs = decode(mt_t, x0).cpu().numpy(), decode(ms_t, x0).cpu().numpy()
                    vmse = float(np.mean((vt - vs) ** 2))
                    rows.append({"mse": float(np.mean((mt - ms) ** 2)),
                                 "rel": float(np.linalg.norm(ms - mt) / (np.linalg.norm(mt) + 1e-8)),
                                 "mom": moments(mt, ms), "vmse": vmse,
                                 "psnr": float(10 * np.log10(4.0 / max(vmse, 1e-12)))})
                else:
                    # fitted to the teacher's distribution: NLL of teacher
                    # samples, and moments of samples from independent z
                    z2 = prng.normal(prng.prng_key(810_000 + j), zshape, device)
                    nll_t = flow_loss(*transformer.forward(teacher["flow"], spec.flow, mt_t, c))[0]
                    nll_s = flow_loss(*transformer.forward(state["params"], student, mt_t, c))[0]
                    ms = transformer.reverse(state["params"], student, z2, c).float().cpu().numpy()
                    rows.append({"nll_t": float(nll_t), "nll_s": float(nll_s), "mom": moments(mt, ms)})
        mean = lambda key, i=None: statistics.mean(  # noqa: E731
            r[key] if i is None else r[key][i] for r in rows)
        if args.student == "direct":
            out = {"heldout_motion_mse": mean("mse"), "heldout_motion_rel_err": mean("rel"),
                   "heldout_video_mse_to_teacher": mean("vmse"),
                   "heldout_video_psnr_to_teacher_db": mean("psnr")}
        else:
            out = {"heldout_student_nll": mean("nll_s"), "teacher_self_nll_floor": mean("nll_t"),
                   "heldout_nll_gap_nats": mean("nll_s") - mean("nll_t")}
        out.update(heldout_moment_mean_maxdiff=mean("mom", 0),
                   heldout_moment_std_maxreldiff=mean("mom", 1), n_eval_batches=n_batches)
        return out

    losses, step_s, eval_curve = [], [], []
    finite_frac = []
    eval_wall = 0.0
    for i in range(args.steps):
        z = prng.normal(prng.prng_key(100 + i), zshape, device)
        sync()
        t0 = time.perf_counter()
        state, logs = step(state, teacher, z, pool[i % len(pool)])
        loss = float(logs["loss"])   # a host read: the step has finished
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        if "teacher_finite_frac" in logs:
            finite_frac.append(float(logs["teacher_finite_frac"]))
        if i == 0 or i % 50 == 0 or i == args.steps - 1:
            log(f"step {i}: loss {loss:.6g}, {step_s[-1] * 1e3:.1f} ms")
        if args.eval_every and i > 0 and i % args.eval_every == 0:
            te0 = time.perf_counter()
            ev = evaluate(max(1, args.eval_batches or 2))
            eval_curve.append({"step": i, **ev})
            log(f"eval @ {i}: {ev}")
            eval_wall += time.perf_counter() - te0
        if args.budget_s and time.time() - T0 > args.budget_s:
            log(f"budget exceeded at step {i}; stopping early")
            break

    final_eval = evaluate(args.eval_batches) if args.eval_batches > 0 else None
    if final_eval:
        log(f"final eval: {final_eval}")
    if args.save:
        import os

        from ipoke_tpu_torch.ckpt import io
        from ipoke_tpu_torch.experiments.distill import unbridge_student

        os.makedirs(os.path.dirname(args.save) or ".", exist_ok=True)
        meta = {"kind": args.student, "hidden": args.student_hidden, "depth": args.student_depth,
                "model": args.model, "teacher_init": args.init, "steps_trained": int(state["step"])}
        if args.student == "flow":
            meta["num_steps"] = list(student.num_steps)
        io.save(args.save, unbridge_student(student, state["params"]), metadata=meta)
        log(f"student saved -> {args.save}")

    steady = sorted(step_s[1:])
    print(json.dumps({
        "student": args.student, "batch": b, "steps_run": int(state["step"]),
        "cond_pool": args.cond_pool, "loss_first": losses[0] if losses else None,
        "loss_last": losses[-1] if losses else None,
        "losses": losses if len(losses) <= 10 else losses[:4] + ["..."] + losses[-4:],
        "teacher_finite_frac_min": min(finite_frac) if finite_frac else None,
        "step_ms_first": step_s[0] * 1e3 if step_s else None,
        "step_ms_median": steady[len(steady) // 2] * 1e3 if steady else None,
        "eval_wall_s": eval_wall, "eval_curve": eval_curve, "final_eval": final_eval,
        "saved": args.save, "wall_s": time.time() - T0,
        "device": card_line() if cuda else str(device),
    }), flush=True)


if __name__ == "__main__":
    main()
