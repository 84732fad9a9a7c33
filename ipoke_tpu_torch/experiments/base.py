"""The training loop and a run's directories (the port's counterpart of
``Experiment`` in ``ipoke_tpu/experiments/base.py``): ``fit`` is JAX's
``Experiment.fit`` with ``_run_validation``, ``run_dir`` its version
directory, ``maybe_resume`` its resume from ``last.npz``.
"""
from __future__ import annotations

import logging
import os
import signal
import time

from ipoke_tpu_torch.ckpt import io
from ipoke_tpu_torch.data.loader import device_prefetch
from ipoke_tpu_torch.utils.logging import RunLogger

MONITOR = "FVD-val"

log = logging.getLogger(__name__)


def fit(step, n_epochs, epoch_batches, max_batches_per_epoch=None, validate=None,
        val_every_steps=None, max_steps=None, start_step=0, run_log=None, log_every=50,
        save_preempted=None):
    """Run ``step(batch)`` on the batches of ``epoch_batches()``, called
    afresh for every epoch as JAX's ``Experiment.fit`` calls
    ``loader("train")``, at most ``max_batches_per_epoch`` of them per epoch,
    for ``n_epochs`` epochs; and ``validate(step_i)`` where JAX's ``fit``
    runs its validation: after every step ``step_i`` that ``val_every_steps``
    divides, and at the end of every epoch (both, where they meet).

    The step counter starts at ``start_step`` (a resumed state's step, as
    JAX's ``step_i = int(state.step)``); the epochs start at 0 all the same.
    ``max_steps`` stops the run after that many steps of this call, counted
    from ``start_step``; an epoch's end is validated only when its last step
    ran.  ``run_log`` (a ``utils/logging.RunLogger``) gets the step's
    returned metrics with the prefix ``train/`` after every step
    ``log_every`` divides (JAX's constant 50 unless a caller asks for
    another), and the metrics a validation returns, unprefixed.
    SIGTERM and SIGINT are trapped while the loop runs (where this is the
    main thread): after the step in flight (its log and validation
    included) ``save_preempted(step_i)`` is called and the loop returns.
    The handlers found are restored on every way out.  Returns the step
    counter at the end.
    """
    step_i = start_step
    flag = []
    old = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            old[sig] = signal.signal(sig, lambda signum, frame: flag.append(signum))
        except ValueError:   # not the main thread
            pass
    try:
        for _ in range(n_epochs):
            for bi, batch in enumerate(epoch_batches()):
                if max_batches_per_epoch and bi >= max_batches_per_epoch:
                    break
                if max_steps is not None and step_i - start_step >= max_steps:
                    return step_i
                metrics = step(batch)
                step_i += 1
                if run_log is not None and step_i % log_every == 0:
                    run_log.log_scalars(step_i, metrics or {}, prefix="train/")
                if validate and val_every_steps and step_i % val_every_steps == 0:
                    _validation(validate, step_i, run_log)
                if flag:
                    log.warning("preemption signal: saving last checkpoint")
                    if save_preempted is not None:
                        save_preempted(step_i)
                    return step_i
            if validate:
                _validation(validate, step_i, run_log)
        return step_i
    finally:
        for sig, handler in old.items():
            signal.signal(sig, handler)


def _validation(validate, step_i, run_log):
    metrics = validate(step_i)
    if run_log is not None and metrics:
        run_log.log_scalars(step_i, metrics, prefix="")


def train_loader(datamod, device, keys):
    """``epoch_batches`` for ``fit``: the ``keys`` of each batch of
    ``datamod.loader("train")`` on ``device``, copied one batch ahead
    (``data/loader.device_prefetch``)."""
    return lambda: device_prefetch(datamod.loader("train"), device, keys)


def debug_shrink(config):
    """The JAX experiment's ``general.debug`` shrink: 10 batches per epoch,
    2 validation batches, one loader thread."""
    if config["general"].get("debug"):
        cfg_t = config.setdefault("training", {})
        cfg_t["max_batches_per_epoch"] = 10
        cfg_t["max_val_batches"] = 2
        config["data"]["n_workers"] = 1


# ---------------------------------------------------------------------------
# run directories, the run log, resume
# ---------------------------------------------------------------------------

def _versions(ckpt_root):
    return ([int(d) for d in os.listdir(ckpt_root) if d.isdigit()]
            if os.path.isdir(ckpt_root) else [])


def version_dir(ckpt_root):
    """The version directory a test, serving or resumed run reads: the
    newest integer directory under ``ckpt_root`` that holds a checkpoint,
    else the newest, else ``0``."""
    existing = _versions(ckpt_root)
    if not existing:
        return os.path.join(ckpt_root, "0")
    with_ckpt = [v for v in sorted(existing, reverse=True)
                 if io.find_best(os.path.join(ckpt_root, str(v)))]
    return os.path.join(ckpt_root, str(with_ckpt[0] if with_ckpt else max(existing)))


def new_version_dir(ckpt_root):
    """A fresh training run's version directory: one past the newest."""
    existing = _versions(ckpt_root)
    path = os.path.join(ckpt_root, str(max(existing) + 1 if existing else 0))
    os.makedirs(path, exist_ok=True)
    return path


def run_dir(config, dirs):
    """A training run's version directory, as JAX's ``Experiment.__init__``
    picks it: with ``general.restart`` (``--resume``) the one
    ``version_dir`` reads, else a fresh one."""
    if config["general"].get("restart"):
        path = version_dir(dirs["ckpt"])
        os.makedirs(path, exist_ok=True)
        return path
    return new_version_dir(dirs["ckpt"])


def run_logger(dirs):
    """The run's ``RunLogger`` on ``dirs["log"]``, or None without that
    directory."""
    return RunLogger(dirs["log"]) if "log" in dirs else None


def maybe_resume(config, ckpt_dir, state, restore, timings=None):
    """JAX's ``Experiment.maybe_resume``: without ``general.restart``,
    ``state``; else ``restore(tree)`` of ``<ckpt_dir>/last.npz``, or
    ``state`` with a warning where there is no such file or its tree is of
    another structure (``restore`` raises KeyError or TypeError).  A leaf of
    another shape (a config of other widths) raises ValueError, before
    anything is written over the run's checkpoints, as JAX's step fails on
    it.  ``timings`` gets ``load_s`` and ``restore_s``."""
    if not config["general"].get("restart"):
        return state
    path = os.path.join(ckpt_dir, "last.npz")
    if not os.path.exists(path):
        log.warning("--resume but no last.npz here; training fresh")
        return state
    t0 = time.perf_counter()
    tree, meta = io.load(path)
    t1 = time.perf_counter()
    try:
        restored = restore(tree)
    except (KeyError, TypeError) as e:
        log.warning(f"resume failed ({e!r}); training fresh")
        return state
    if timings is not None:
        timings.update(load_s=t1 - t0, restore_s=time.perf_counter() - t1)
    log.info(f"resumed the train state from {path} (meta {meta})")
    return restored


def preempt_saver(ckpt_dir, ckpt_tree, record):
    """``save_preempted`` for ``fit``: ``ckpt_tree()`` to
    ``<ckpt_dir>/last.npz`` with the metadata ``{"step": step_i,
    "preempted": True}``, as JAX's ``fit`` writes it; ``record["preempted"]``
    is set to the step."""
    def save(step_i):
        io.save(os.path.join(ckpt_dir, "last.npz"), ckpt_tree(),
                metadata={"step": step_i, "preempted": True})
        record["preempted"] = step_i
    return save
