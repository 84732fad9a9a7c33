"""LR schedules (counterpart of ``ipoke_tpu/train/lr.py``).  The optimizer
reads one learning rate per step, a Python number rounded as JAX's f32
schedule rounds it."""
from __future__ import annotations

import numpy as np


def linear_var(it, start_it, end_it, start_val, end_val, clip_min, clip_max):
    """``start_val -> end_val`` over ``[start_it, end_it]``, in f32 as JAX."""
    f32 = np.float32
    act_it = min(max(it, start_it), end_it)
    denom = max(end_it - start_it, 1)
    val = f32(start_val) + f32(end_val - start_val) * f32(act_it - start_it) / f32(denom)
    return float(min(max(val, f32(clip_min)), f32(clip_max)))


def second_stage_schedule(lr, warmup_steps, total_steps):
    """0 -> lr over warmup_steps, then linear decay lr -> 0 over the rest."""

    def schedule(step):
        if step < warmup_steps:
            return linear_var(step, 0, warmup_steps, 0.0, lr, 0.0, lr)
        return linear_var(step, warmup_steps, total_steps, lr, 0.0, 0.0, lr)

    return schedule
