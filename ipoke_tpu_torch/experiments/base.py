"""The training loop's schedule (the port's counterpart of
``Experiment.fit`` and ``_run_validation`` in ``ipoke_tpu/experiments/base.py``).
"""
from __future__ import annotations

MONITOR = "FVD-val"


def fit(step, n_epochs, steps_per_epoch, validate=None, val_every_steps=None, max_steps=None):
    """Run ``step()`` ``steps_per_epoch`` times per epoch for ``n_epochs``
    epochs, and ``validate(step_i)`` where JAX's ``Experiment.fit`` runs its
    validation: after every step ``step_i`` that ``val_every_steps`` divides,
    and at the end of every epoch (both, where they meet).  ``max_steps``
    stops the run after that many steps; an epoch's end is validated only
    when its last step ran.  Returns the number of steps run.

    An epoch here is ``steps_per_epoch`` batches of an endless train
    stream, as JAX's is ``max_batches_per_epoch`` when the train loader
    holds at least that many."""
    step_i = 0
    for _ in range(n_epochs):
        for _ in range(steps_per_epoch):
            if max_steps is not None and step_i >= max_steps:
                return step_i
            step()
            step_i += 1
            if validate and val_every_steps and step_i % val_every_steps == 0:
                validate(step_i)
        if validate:
            validate(step_i)
    return step_i
