"""The per-level flow trainer (counterpart of ``ipoke_tpu/train/chunked.py``'s
``make_per_level_trainer``).

The multi-scale flow's loss is analytic in its outputs:

  loss = mean_B[ 0.5 * sum(z^2) ] - w * mean_B[ logdet ],
  z    = concat(final carry, z2_{L-1}, ..., z2_0)

so the cotangent of each factored-out ``z2_i`` is ``z2_i / B``, of the
final carry ``carry / B`` and of each level's logdet ``-w / B``.  A step runs
the forward level by level without a graph, keeping each level's input;
then, from the deepest level down, it recomputes that level's forward from
its detached input, takes the level's gradients and its input's cotangent
with one ``torch.autograd.grad``, updates the level's float leaves in place
with the level's own optimizer and drops the gradients.  Only one level's
activations and gradients are live at a time.  The optimizers are
element-wise or per leaf, so the result is the one-graph step's with the same
optimizer (no global-norm clipping here, as in JAX).

JAX's ``make_chunked_trainer`` (one global update) maps onto the one-graph
step: ``training.chunked`` in ``experiments/second_stage``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ipoke_tpu_torch.flows import macow
from ipoke_tpu_torch.models import second_stage
from ipoke_tpu_torch.train.second_stage import float_leaves

METRICS = ("flow_loss", "nll_loss", "nlogdet_loss")


class PerLevelTrainState(NamedTuple):
    step: int
    levels: list          # per-level param trees, updated in place
    opt_states: list      # per-level optimizer states


def flow_loss_and_grads(levels, spec_flow: macow.FlowSpec, x, h, on_level,
                        logdet_weight: float = 1.0, spatial_mean: bool = False):
    """The flow loss of motion ``x`` under conditioning ``h`` and each
    level's gradients, deepest level first: ``on_level(i, params, grads)``
    gets level i's float leaves and their gradients (the caller updates and
    drops them) before level i - 1's backward runs.  Returns ``(loss, nll,
    logdet_total)``, JAX's ``flow_loss_and_grads`` values."""
    chans, factors = spec_flow.level_channels(), spec_flow.level_factors()

    def forward(i, x_i):
        return macow.level_forward(levels[i], x_i, h, chans[i], factors[i], spec_flow)

    with torch.no_grad():
        b = x.shape[0]
        hw = x.shape[1] * x.shape[2] if spatial_mean else 1
        nll_scale = 1.0 / (b * hw)
        ld_scale = logdet_weight / (b * hw)
        xs, z2s, lds = [], [], []
        carry = x
        for i in range(len(levels)):
            xs.append(carry)
            carry, z2, ld = forward(i, carry)
            z2s.append(z2)
            lds.append(ld)
        nll = 0.5 * (torch.sum(carry.float() ** 2)
                     + sum(torch.sum(z.float() ** 2) for z in z2s)) * nll_scale
        logdet_total = sum(torch.sum(ld.float()) for ld in lds)
        loss = nll - ld_scale * logdet_total
        cot_carry = carry * nll_scale
    cot_ld = torch.full((b,), -ld_scale, dtype=torch.float32, device=x.device)
    for i in reversed(range(len(levels))):
        params = float_leaves(levels[i])
        x_i = xs[i].detach().requires_grad_(i > 0)
        with torch.enable_grad():
            outs = forward(i, x_i)
            grads = torch.autograd.grad(outs, params + ([x_i] if i > 0 else []),
                                        grad_outputs=(cot_carry, z2s[i] * nll_scale, cot_ld),
                                        allow_unused=True)
        del outs
        cot_carry = grads[-1] if i > 0 else None
        on_level(i, params, [torch.zeros_like(p) if g is None else g
                             for p, g in zip(params, grads)])
        del grads
        xs[i] = z2s[i] = None
    return loss, nll, logdet_total


def make_per_level_trainer(spec_flow: macow.FlowSpec, full_spec, frozen_params, make_opt,
                           logdet_weight: float = 1.0, spatial_mean: bool = False):
    """``train_step(state, batch, rng=None) -> (state, metrics)`` with
    ``train_step.init_state(flow_params) -> PerLevelTrainState``.

    ``make_opt(level_params) -> Optimizer`` gives each level a fresh
    optimizer (its schedule advances in lockstep, since every level updates
    every step).  ``frozen_params``: the towers and the first stage, which
    embed ``batch['images'][:, 0]`` and ``batch['poke']`` and encode the
    motion, under ``no_grad``.  ``rng`` is unused, as in JAX."""
    opts = {}

    def opt_of(i, level):
        if i not in opts:
            opts[i] = make_opt(level)
        return opts[i]

    def init_state(flow_params):
        levels = list(flow_params["levels"])
        opt_states = []
        for i, level in enumerate(levels):
            for p in float_leaves(level):
                p.requires_grad_(True)
            opt_states.append(opt_of(i, level).init(level))
        return PerLevelTrainState(0, levels, opt_states)

    def train_step(state: PerLevelTrainState, batch, rng=None):
        images = batch["images"]
        with torch.no_grad():
            cond = second_stage.embed_cond(frozen_params, full_spec, images[:, 0], batch["poke"])
            motion, _ = second_stage.encode_first_stage(frozen_params, full_spec, images)

        def update(i, params, grads):
            with torch.no_grad():
                torch._foreach_add_(params, opt_of(i, state.levels[i]).update(
                    grads, state.opt_states[i], params))

        loss, nll, logdet_total = flow_loss_and_grads(
            state.levels, spec_flow, motion, cond, update, logdet_weight=logdet_weight,
            spatial_mean=spatial_mean)
        metrics = {"flow_loss": loss, "nll_loss": nll,
                   "nlogdet_loss": -logdet_total / motion.shape[0]}
        return PerLevelTrainState(state.step + 1, state.levels, state.opt_states), metrics

    train_step.init_state = init_state
    return train_step
