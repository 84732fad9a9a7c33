"""Distillation runs from a config (counterpart of
``ipoke_tpu/experiments/distill.py``, config ``general.experiment: distill``).

The model name (-m) addresses the teacher's second-stage run tree; the
student trains into a fresh version directory under ``<base>/distill``.

    python -m ipoke_tpu_torch.experiments.distill {train,test} -c <cfg> -m <name> \\
        [--max-steps N] [--device cpu]

``train`` distils the teacher's sampling path into the ``distill:`` section's
student (``direct``: hidden, depth; ``flow``: num_steps, default one step per
level) with optax's ``adam(distill.lr)`` on the config's data in JAX's order
(``data/datamodule.StaticDataModule``), validates
by ``distill-val`` (the held-out MSE or NLL) and keeps the top-k checkpoints
and ``last.npz`` in JAX's npz layout, optax's state included.  ``test`` writes teacher and student
videos of the first test batches side by side.
"""
from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from ipoke_tpu_torch import resolve_device
from ipoke_tpu_torch.ckpt import io
from ipoke_tpu_torch.ckpt.jax_bridge import (
    bridge_direct, bridge_flow, bridge_second_stage, unbridge_direct, unbridge_flow)
from ipoke_tpu_torch.data.datamodule import StaticDataModule
from ipoke_tpu_torch.ckpt.optax_layout import conform, from_optax, to_optax
from ipoke_tpu_torch.data.loader import to_device
from ipoke_tpu_torch.experiments import base
from ipoke_tpu_torch.experiments.base import debug_shrink, fit, train_loader, version_dir
from ipoke_tpu_torch.experiments.second_stage import build_spec_from_config
from ipoke_tpu_torch.flows import transformer
from ipoke_tpu_torch.models import second_stage
from ipoke_tpu_torch.train import distill
from ipoke_tpu_torch.train import second_stage as train_ss
from ipoke_tpu_torch.utils import prng
from ipoke_tpu_torch.utils.video import save_video

log = logging.getLogger(__name__)

MONITOR = "distill-val"


def _seed(config):
    return int(config["general"].get("seed", 42))


def student_of(config, spec):
    """The ``distill:`` section's student: a DirectStudentSpec or a student
    FlowSpec."""
    dcfg = config.get("distill", {})
    kind = dcfg.get("student", "direct")
    if kind == "direct":
        return distill.DirectStudentSpec(hidden=int(dcfg.get("hidden", 256)),
                                         depth=int(dcfg.get("depth", 6)))
    if kind == "flow":
        num_steps = dcfg.get("num_steps") or [1] * len(spec.flow.num_steps)
        return distill.flow_student_spec(spec.flow, tuple(int(n) for n in num_steps))
    raise ValueError(f"distill.student must be direct|flow, got {kind}")


def teacher_root(config, dirs):
    """``distill.teacher_ckpt`` (a directory or a file) wins; else the same
    model name's second_stage run tree."""
    explicit = config.get("distill", {}).get("teacher_ckpt")
    if explicit:
        return explicit
    sep = os.sep
    return dirs["ckpt"].replace(f"{sep}distill{sep}", f"{sep}second_stage{sep}")


def load_teacher(config, dirs, spec, device):
    """The teacher: ``init`` at the config's seed with the best checkpoint of
    the newest version that has one laid over it (its trainable keys, or
    every component of a full-model checkpoint); a fresh teacher, with a
    warning, when there is none."""
    root = teacher_root(config, dirs)
    best = root if os.path.isfile(root) else io.find_best(version_dir(root))
    params = second_stage.init(prng.prng_key(_seed(config)), spec, device)
    if best:
        tree, _ = io.load(best)
        saved = tree.get("params", tree)
        loaded = {k: v for k, v in saved.items() if k in train_ss.TRAINABLE_KEYS}
        if not loaded:
            loaded = {k: v for k, v in saved.items() if k in params}
        params.update(bridge_second_stage(loaded, spec, device))
        log.info("teacher checkpoint: %s (%s)", best, sorted(loaded))
    else:
        log.warning("no teacher checkpoint found; distilling a FRESH teacher "
                    "(smoke/debug only — the student will imitate random weights)")
    return params


def _z_shape(spec, student, b):
    flow_spec = spec.flow if isinstance(student, distill.DirectStudentSpec) else student
    return transformer.reverse_input_shape(flow_spec, b, spec.latent_size, spec.flow_in_channels)


DATAKEYS = BATCH_KEYS = ("images", "poke")   # DistillExperiment.datakeys


def unbridge_student(student, tree):
    """A student's params (or an optimizer moment in their layout) in JAX's
    layout, as numpy."""
    if isinstance(student, distill.DirectStudentSpec):
        return unbridge_direct(tree)
    return unbridge_flow(tree)


def bridge_student(student, tree, device):
    if isinstance(student, distill.DirectStudentSpec):
        return bridge_direct(tree, device)
    return bridge_flow(tree, device)


def make_optimizer(config, student):
    """optax's ``adam(distill.lr)``; for a flow student under
    ``multi_transform`` with the integer leaves frozen, as JAX's
    ``make_distill_step`` wraps it."""
    return train_ss.adam(float(config.get("distill", {}).get("lr", 1e-4)),
                         masked=not isinstance(student, distill.DirectStudentSpec))


def ckpt_tree(state, optimizer, student):
    """The distill state as JAX's checkpoint holds it: step, the student's
    params in JAX's layout, and optax's state (``ckpt/optax_layout``)."""
    export = lambda tree: unbridge_student(student, tree)   # noqa: E731
    return {"params": export(state["params"]),
            "opt": to_optax(optimizer, state["opt"], state["params"], export),
            "step": np.asarray(state["step"], np.int32)}


def restore_state(tree, optimizer, student, template, device=None):
    """``ckpt_tree``'s inverse for a JAX or a port ``last.npz``: the student
    must have ``template``'s keys and shapes (KeyError, ValueError)."""
    device = resolve_device(device)
    bridge = lambda t: bridge_student(student, t, device)   # noqa: E731
    params = conform(template["params"], bridge(tree["params"]))
    opt = from_optax(optimizer, tree["opt"], params, bridge)
    for p in train_ss.float_leaves(params):
        p.requires_grad_(True)
    return {"params": params, "opt": opt, "step": int(tree["step"])}


def validate(state, teacher, spec, student, config, device, datamod=None):
    """Held-out distillation loss (MSE for direct / NLL for flow) over the
    first ``max_val_batches`` batches of ``datamod.loader("val")`` (the
    trainer's data module; by default a fresh one of the config's data), z
    from ``prng_key(9000 + bi)``."""
    is_direct = isinstance(student, distill.DirectStudentSpec)
    data_cfg = config["data"]
    max_b = int(config.get("training", {}).get("max_val_batches", 4))
    losses = []
    datamod = datamod or StaticDataModule(data_cfg, datakeys=DATAKEYS)
    for bi, batch in enumerate(datamod.loader("val")):
        if bi >= max_b:
            break
        batch = to_device(batch, device, BATCH_KEYS)
        x0 = batch["images"][:, 0]
        cond = second_stage.embed_cond(teacher, spec, x0, batch["poke"])
        z = prng.normal(prng.prng_key(9000 + bi), _z_shape(spec, student, x0.shape[0]), device)
        with torch.no_grad():
            if is_direct:
                loss = distill.direct_loss(state["params"], student, teacher, spec, z, cond)[0]
            else:
                loss = distill.flow_student_loss(state["params"], student, teacher, spec, z, cond)[0]
        losses.append(float(loss))
    return {MONITOR: float(np.mean(losses)) if losses else float("nan")}


def train(config, dirs, device=None, max_steps=None):
    """Distil as ``DistillExperiment.train`` does: the teacher's cond from
    ``embed_cond``, step i's z ``prng.normal(sub, z_shape)`` with ``rng, sub
    = split(rng)`` from ``prng_key(seed + 1)``, on JAX's schedule
    (``experiments/base.fit``): a validation every ``val_every`` epochs'
    worth of steps and at each epoch's end, each a top-k checkpoint (and
    ``last.npz``) and a record in ``<log dir>/metrics.jsonl``; the run log,
    the save on SIGTERM/SIGINT and ``--resume`` as in
    ``experiments/second_stage.train``.  JAX's ``fit`` reads no step from a
    distill state (a dict), so its counter, and with it the schedule, the
    checkpoint names and a preempted save's step, start at 0 on a resumed run
    while the state's ``step`` goes on; the port does the same.
    ``max_steps`` stops after that many steps of this run; ``last.npz`` is
    written at the end too when the last step was not validated.

    Returns a dict: ``state``, ``student``, ``spec``, ``ckpt_dir``,
    ``resume``, ``preempted``, ``history`` (per step: its logs as floats)
    and ``val`` (per validation: step and ``distill-val``)."""
    device = resolve_device(device)
    cfg_t = config.setdefault("training", {})
    debug_shrink(config)
    spec = build_spec_from_config(config)
    student = student_of(config, spec)
    teacher = load_teacher(config, dirs, spec, device)
    opt = make_optimizer(config, student)
    init_state, dstep = distill.make_distill_step(spec, student, opt)
    state = init_state(prng.prng_key(_seed(config)), device)
    ckpt_dir = base.run_dir(config, dirs)
    mgr = io.CheckpointManager(ckpt_dir, monitor=MONITOR,
                               top_k=int(config.get("logging", {}).get("n_saved_ckpt", 5)))
    run_log = base.run_logger(dirs)
    resume = {}
    state = base.maybe_resume(config, ckpt_dir, state,
                              lambda tree: restore_state(tree, opt, student, state, device),
                              timings=resume)
    steps_per_epoch = int(cfg_t.get("max_batches_per_epoch", 500))
    datamod = StaticDataModule(config["data"], datakeys=DATAKEYS)
    run = {"state": state, "rng": prng.prng_key(_seed(config) + 1), "preempted": None}
    del state
    history, vals = [], []

    def step(batch):
        run["rng"], sub = prng.split(run["rng"])
        x0 = batch["images"][:, 0]
        cond = second_stage.embed_cond(teacher, spec, x0, batch["poke"])
        z = prng.normal(sub, _z_shape(spec, student, x0.shape[0]), device)
        run["state"], logs = dstep(run["state"], teacher, z, cond)
        history.append({k: float(v) for k, v in logs.items()})
        log.info("step %d: %s", run["state"]["step"], " ".join(
            f"{k}={v:.4f}" for k, v in history[-1].items()))
        return history[-1]

    def run_validation(step_i):
        metrics = validate(run["state"], teacher, spec, student, config, device, datamod)
        if MONITOR in metrics:
            mgr.save_step(ckpt_tree(run["state"], opt, student), step_i, metrics[MONITOR])
        vals.append({"step": step_i, **metrics})
        log.info("step %d: %s=%.6g", step_i, MONITOR, metrics[MONITOR])
        return metrics

    n_steps = fit(step, int(cfg_t.get("n_epochs", 10)), train_loader(datamod, device, BATCH_KEYS),
                  steps_per_epoch, validate=run_validation,
                  val_every_steps=int(steps_per_epoch * float(cfg_t.get("val_every", 1.0))),
                  max_steps=max_steps, run_log=run_log,
                  save_preempted=base.preempt_saver(
                      ckpt_dir, lambda: ckpt_tree(run["state"], opt, student), run))
    if run["preempted"] is None and (not vals or vals[-1]["step"] != n_steps):
        io.save(os.path.join(ckpt_dir, "last.npz"), ckpt_tree(run["state"], opt, student),
                metadata={"step": n_steps})
    return {"state": run["state"], "student": student, "spec": spec, "ckpt_dir": ckpt_dir,
            "resume": resume, "preempted": run["preempted"], "history": history, "val": vals}


def test(config, dirs, device=None):
    """Teacher and student videos of the first ``testing.n_examples`` test
    batches, each on key ``prng_key(1000 + bi)``, under
    ``<generated>/distill_samples`` (mp4, or npy without cv2)."""
    device = resolve_device(device)
    spec = build_spec_from_config(config)
    student = student_of(config, spec)
    teacher = load_teacher(config, dirs, spec, device)
    best = io.find_best(version_dir(dirs["ckpt"]))
    if not best:
        raise FileNotFoundError(f"no student checkpoint under {dirs['ckpt']}; train first")
    tree, _ = io.load(best)
    student_params = bridge_student(student, tree.get("params", tree), device)
    log.info("student checkpoint: %s", best)
    out_dir = os.path.join(dirs["generated"], "distill_samples")
    os.makedirs(out_dir, exist_ok=True)
    n = int(config.get("testing", {}).get("n_examples", 2))
    written = []
    for bi, batch in enumerate(StaticDataModule(config["data"], datakeys=DATAKEYS).loader("test")):
        if bi >= n:
            break
        batch = to_device(batch, device, BATCH_KEYS)
        key = prng.prng_key(1000 + bi)
        vid_t = second_stage.forward_sample(teacher, spec, batch, key, add_first_frame=True)[0]
        vid_s = distill.forward_sample_student(teacher, student_params, student, spec, batch, key,
                                               add_first_frame=True)[0]
        for name, vid in (("teacher", vid_t), ("student", vid_s)):
            written.append(save_video(vid[0].float().cpu().numpy(),
                                      os.path.join(out_dir, f"ex{bi}_{name}.mp4")))
    return {"n_examples": n, "dir": out_dir, "files": written}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ipoke_tpu_torch.experiments.distill")
    ap.add_argument("command", choices=["train", "test"])
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' only when asked)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    from ipoke_tpu_torch.config import load_parameters

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:   # no CUDA device and no --device
        raise SystemExit(f"{e}; on the command line: --device cpu") from None
    if args.command == "train":
        cfg, dirs = load_parameters(args.config, args.model)
        run = train(cfg, dirs, device=device, max_steps=args.max_steps)
        last = run["history"][-1] if run["history"] else {}
        print(f"distilled {run['state']['step']} steps on {device}; last loss "
              f"{last.get('loss', float('nan')):.4f}; {MONITOR} "
              f"{run['val'][-1][MONITOR] if run['val'] else float('nan'):.4f}; "
              f"checkpoints in {run['ckpt_dir']}", flush=True)
    else:
        cfg, dirs = load_parameters(args.config, args.model, test_mode="samples")
        res = test(cfg, dirs, device=device)
        print(f"wrote {len(res['files'])} videos to {res['dir']}", flush=True)


if __name__ == "__main__":
    main()
