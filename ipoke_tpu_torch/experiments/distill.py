"""Distillation runs from a config (counterpart of
``ipoke_tpu/experiments/distill.py``, config ``general.experiment: distill``).

The model name (-m) addresses the teacher's second-stage run tree; the
student trains into a fresh version directory under ``<base>/distill``.

    python -m ipoke_tpu_torch.experiments.distill {train,test} -c <cfg> -m <name> \\
        [--max-steps N] [--device cpu]

``train`` distils the teacher's sampling path into the ``distill:`` section's
student (``direct``: hidden, depth; ``flow``: num_steps, default one step per
level) with optax's ``adam(distill.lr)`` on the synthetic dataset, validates
by ``distill-val`` (the held-out MSE or NLL) and keeps the top-k checkpoints
and ``last.npz`` in JAX's npz layout.  ``test`` writes teacher and student
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
from ipoke_tpu_torch.data.synthetic import eval_batches, from_data_config, train_batches
from ipoke_tpu_torch.experiments.second_stage import (
    build_spec_from_config, new_version_dir, version_dir)
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


def _to_device(batch, device):
    return {k: torch.from_numpy(batch[k]).to(device) for k in ("images", "poke")}


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


def ckpt_tree(state, optimizer, student):
    """The distill state as JAX's checkpoint holds it: step, the student's
    params in JAX's layout, and the optimizer state under the port's keys
    (moments in the params' layout)."""
    opt = {name: {k: (unbridge_student(student, v) if isinstance(v, (dict, list))
                      else np.asarray(v)) for k, v in s.items()}
           for name, s in optimizer.state_tree(state["opt"], state["params"]).items()}
    return {"params": unbridge_student(student, state["params"]), "opt": opt,
            "step": np.asarray(state["step"], np.int32)}


def validate(state, teacher, spec, student, config, device):
    """Held-out distillation loss (MSE for direct / NLL for flow) over the
    first ``max_val_batches`` validation batches, z from ``prng_key(9000 + bi)``."""
    is_direct = isinstance(student, distill.DirectStudentSpec)
    data_cfg = config["data"]
    max_b = int(config.get("training", {}).get("max_val_batches", 4))
    losses = []
    batches = eval_batches(from_data_config(data_cfg, train=False), int(data_cfg.get("batch_size", 8)))
    for bi, batch in zip(range(max_b), batches):
        batch = _to_device(batch, device)
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
    = split(rng)`` from ``prng_key(seed + 1)``, validation every
    ``val_every`` epochs' worth of steps and at each epoch's end, each
    validation a top-k checkpoint (and ``last.npz``).  ``max_steps`` stops
    early, with a validation at the stop.

    Returns a dict: ``state``, ``student``, ``spec``, ``ckpt_dir``,
    ``history`` (per step: its logs as floats) and ``val`` (per validation:
    step and ``distill-val``)."""
    device = resolve_device(device)
    cfg_t = config.setdefault("training", {})
    if config["general"].get("debug"):   # the JAX experiment's debug shrink
        cfg_t["max_batches_per_epoch"] = 10
        cfg_t["max_val_batches"] = 2
    spec = build_spec_from_config(config)
    student = student_of(config, spec)
    teacher = load_teacher(config, dirs, spec, device)
    opt = train_ss.adam(float(config.get("distill", {}).get("lr", 1e-4)))
    init_state, dstep = distill.make_distill_step(spec, student, opt)
    state = init_state(prng.prng_key(_seed(config)), device)
    ckpt_dir = new_version_dir(dirs["ckpt"])
    mgr = io.CheckpointManager(ckpt_dir, monitor=MONITOR,
                               top_k=int(config.get("logging", {}).get("n_saved_ckpt", 5)))
    steps_per_epoch = int(cfg_t.get("max_batches_per_epoch", 500))
    n_epochs = int(cfg_t.get("n_epochs", 10))
    val_every = int(steps_per_epoch * float(cfg_t.get("val_every", 1.0)))
    data_cfg = config["data"]
    batches = train_batches(from_data_config(data_cfg), int(data_cfg.get("batch_size", 8)),
                            seed=int(data_cfg.get("seed", 0)))
    rng = prng.prng_key(_seed(config) + 1)
    history, vals = [], []

    def run_validation():
        metrics = validate(state, teacher, spec, student, config, device)
        mgr.save_step(ckpt_tree(state, opt, student), state["step"], metrics[MONITOR])
        vals.append({"step": state["step"], **metrics})
        log.info("step %d: %s=%.6g", state["step"], MONITOR, metrics[MONITOR])

    total = n_epochs * steps_per_epoch if max_steps is None else min(max_steps, n_epochs * steps_per_epoch)
    for epoch in range(n_epochs):
        for _ in range(steps_per_epoch):
            if state["step"] >= total:
                break
            batch = _to_device(next(batches), device)
            rng, sub = prng.split(rng)
            x0 = batch["images"][:, 0]
            cond = second_stage.embed_cond(teacher, spec, x0, batch["poke"])
            z = prng.normal(sub, _z_shape(spec, student, x0.shape[0]), device)
            state, logs = dstep(state, teacher, z, cond)
            history.append({k: float(v) for k, v in logs.items()})
            log.info("epoch %d step %d: %s", epoch, state["step"], " ".join(
                f"{k}={v:.4f}" for k, v in history[-1].items()))
            if val_every and state["step"] % val_every == 0:
                run_validation()
        run_validation()
        if state["step"] >= total:
            break
    return {"state": state, "student": student, "spec": spec, "ckpt_dir": ckpt_dir,
            "history": history, "val": vals}


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
    data_cfg = config["data"]
    batches = eval_batches(from_data_config(data_cfg, train=False), int(data_cfg.get("batch_size", 8)))
    written = []
    for bi, batch in zip(range(n), batches):
        batch = _to_device(batch, device)
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
