"""The training loop's schedule (the port's counterpart of
``Experiment.fit`` and ``_run_validation`` in ``ipoke_tpu/experiments/base.py``).
"""
from __future__ import annotations

from ipoke_tpu_torch.data.loader import device_prefetch

MONITOR = "FVD-val"


def fit(step, n_epochs, epoch_batches, max_batches_per_epoch=None, validate=None,
        val_every_steps=None, max_steps=None):
    """Run ``step(batch)`` on the batches of ``epoch_batches()``, called
    afresh for every epoch as JAX's ``Experiment.fit`` calls
    ``loader("train")``, at most ``max_batches_per_epoch`` of them per epoch,
    for ``n_epochs`` epochs; and ``validate(step_i)`` where JAX's ``fit``
    runs its validation: after every step ``step_i`` that ``val_every_steps``
    divides, and at the end of every epoch (both, where they meet).
    ``max_steps`` stops the run after that many steps; an epoch's end is
    validated only when its last step ran.  Returns the number of steps run.
    """
    step_i = 0
    for _ in range(n_epochs):
        for bi, batch in enumerate(epoch_batches()):
            if max_batches_per_epoch and bi >= max_batches_per_epoch:
                break
            if max_steps is not None and step_i >= max_steps:
                return step_i
            step(batch)
            step_i += 1
            if validate and val_every_steps and step_i % val_every_steps == 0:
                validate(step_i)
        if validate:
            validate(step_i)
    return step_i


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
