"""Second-stage (cINN) training: one optimizer, NLL + logdet loss
(counterpart of ``ipoke_tpu/train/second_stage.py``).

Only the flow (and the spatial adapters) trains; the first stage and the
conditioning towers are frozen: they run under ``torch.no_grad`` inside the
model and stay out of the optimizer here.  Integer leaves of the flow (the
shuffle permutations) get no gradient and no update.

The optimizers are optax's, written out on the float leaves with
``torch._foreach_*`` ops: ``torch_adam`` (torch.optim.Adam's coupled L2, its
amsgrad), ``optax.adam`` (``adam``), ``optax.adamw``, ``optax.adabelief`` and
``optax.clip_by_global_norm``, each in optax's own formulas (eps, eps_root),
with optax's step count: the schedule reads the count before the update, so
the first step runs at lr(0).  The gradients come from autograd;
microbatches, when asked for, run one after another and their gradients are
averaged.  ``shard_train_setup`` waits for ROADMAP queue 1 item 8.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ipoke_tpu_torch.flows.loss import flow_loss
from ipoke_tpu_torch.models import second_stage
from ipoke_tpu_torch.nn.core import Policy
from ipoke_tpu_torch.train.lr import second_stage_schedule
from ipoke_tpu_torch.utils import prng

TRAINABLE_KEYS = ("flow", "scale_augment", "shift_augment", "conv_adapt_poke_emb", "conv_adapt_cond")


def split_params(params):
    trainable = {k: params[k] for k in TRAINABLE_KEYS if k in params}
    frozen = {k: v for k, v in params.items() if k not in TRAINABLE_KEYS}
    return trainable, frozen


def leaves(tree):
    """The tensors of a nested dict/list tree, depth first in key order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def float_leaves(tree):
    """The leaves the optimizer trains: every floating-point tensor."""
    return [t for t in leaves(tree) if t is not None and t.is_floating_point()]


def like_params(params, values):
    """``params``' tree with its float leaves replaced, in order, by ``values``
    and its integer leaves by None: the layout an optimizer moment is saved in."""
    it = iter(values)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return next(it) if node.is_floating_point() else None

    return walk(params)


def global_norm(tensors):
    """optax.global_norm: the L2 norm of all elements of all tensors."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


# ---------------------------------------------------------------------------
# gradient transformations: init(params) -> state dict;
# update(updates, state, params) -> updates, each a list over the float leaves
# ---------------------------------------------------------------------------

class _Clip:
    """optax.clip_by_global_norm: ``t / norm * max_norm`` when norm >= max_norm."""
    name = "clip"

    def __init__(self, max_norm):
        self.max_norm = max_norm

    def init(self, params):
        return {}

    def update(self, updates, state, params):
        g_norm = global_norm(updates).item()
        if g_norm < self.max_norm:
            return updates
        out = torch._foreach_div(updates, g_norm)
        torch._foreach_mul_(out, self.max_norm)
        return out


class _DecayedWeights:
    """optax.add_decayed_weights: ``g + wd * p``."""
    name = "decayed_weights"

    def __init__(self, weight_decay):
        self.weight_decay = weight_decay

    def init(self, params):
        return {}

    def update(self, updates, state, params):
        return torch._foreach_add(updates, params, alpha=self.weight_decay)


def _zeros(params):
    return [torch.zeros_like(p) for p in params]


def _moments(mu, nu, g, b1, b2):
    """mu <- (1-b1) g + b1 mu;  nu <- (1-b2) g^2 + b2 nu, in place."""
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, g, alpha=1 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, g, g, value=1 - b2)


def _bias_corrections(b1, b2, count):
    return 1 - b1 ** count, 1 - b2 ** count


def _divide(mu, nu, bc1, bc2, eps, eps_root=0.0):
    """(mu / bc1) / (sqrt(nu / bc2 + eps_root) + eps)."""
    den = torch._foreach_div(nu, bc2)
    if eps_root:
        torch._foreach_add_(den, eps_root)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    out = torch._foreach_div(mu, bc1)
    torch._foreach_div_(out, den)
    return out


class _ScaleByAdam:
    """optax.scale_by_adam."""
    name = "adam"

    def __init__(self, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0):
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root

    def init(self, params):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

    def update(self, updates, state, params):
        _moments(state["mu"], state["nu"], updates, self.b1, self.b2)
        state["count"] += 1
        bc1, bc2 = _bias_corrections(self.b1, self.b2, state["count"])
        return _divide(state["mu"], state["nu"], bc1, bc2, self.eps, self.eps_root)


class _ScaleByTorchAmsgrad(_ScaleByAdam):
    """torch.optim.Adam(amsgrad=True): the max is over the raw second moment
    and the bias correction divides the max."""
    name = "amsgrad"

    def init(self, params):
        return dict(super().init(params), nu_max=_zeros(params))

    def update(self, updates, state, params):
        _moments(state["mu"], state["nu"], updates, self.b1, self.b2)
        torch._foreach_maximum_(state["nu_max"], state["nu"])
        state["count"] += 1
        bc1, bc2 = _bias_corrections(self.b1, self.b2, state["count"])
        return _divide(state["mu"], state["nu_max"], bc1, bc2, self.eps)


class _ScaleByBelief(_ScaleByAdam):
    """optax.scale_by_belief: the second moment of the prediction error
    ``g - mu``, with eps_root added to the stored moment."""
    name = "belief"

    def __init__(self, b1=0.9, b2=0.999, eps=1e-16, eps_root=1e-16):
        super().__init__(b1, b2, eps, eps_root)

    def update(self, updates, state, params):
        mu, nu = state["mu"], state["nu"]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, updates, alpha=1 - self.b1)
        err = torch._foreach_sub(updates, mu)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, err, err, value=1 - self.b2)
        torch._foreach_add_(nu, self.eps_root)
        state["count"] += 1
        bc1, bc2 = _bias_corrections(self.b1, self.b2, state["count"])
        return _divide(mu, nu, bc1, bc2, self.eps)


class _ScaleBySchedule:
    """optax.scale_by_learning_rate(schedule): ``-schedule(count) * u``,
    then count + 1."""
    name = "schedule"

    def __init__(self, schedule):
        self.schedule = schedule

    def init(self, params):
        return {"count": 0}

    def update(self, updates, state, params):
        lr = self.schedule(state["count"])
        state["count"] += 1
        return torch._foreach_mul(updates, -lr)


class Optimizer:
    """A chain of gradient transformations over a param tree's float leaves
    (``make_optimizer``'s result)."""

    def __init__(self, transforms):
        self.transforms = list(transforms)

    def init(self, params_tree):
        p = float_leaves(params_tree)
        return [t.init(p) for t in self.transforms]

    def update(self, grads, state, params):
        """Updates for the float leaves ``params`` from their ``grads``."""
        for t, s in zip(self.transforms, state):
            grads = t.update(grads, s, params)
        return grads

    def state_tree(self, state, params_tree):
        """The state as a tree to save: each transform's under its name, a
        moment in ``params_tree``'s layout (None at the integer leaves)."""
        return {t.name: {k: (like_params(params_tree, v) if isinstance(v, list) else v)
                         for k, v in s.items()}
                for t, s in zip(self.transforms, state)}


def torch_adam(schedule, weight_decay: float = 0.0, amsgrad: bool = False):
    """torch.optim.Adam semantics: coupled L2 (``wd * param`` added to the
    gradient before the moments), optional amsgrad; the reference's optimizer."""
    steps = [_DecayedWeights(weight_decay)] if weight_decay else []
    steps.append(_ScaleByTorchAmsgrad() if amsgrad else _ScaleByAdam())
    return steps + [_ScaleBySchedule(schedule)]


def adam(lr: float) -> Optimizer:
    """optax.adam(lr): scale_by_adam, then a constant scale of -lr; no decay
    (the distillation experiment's optimizer)."""
    return Optimizer([_ScaleByAdam(), _ScaleBySchedule(lambda count: lr)])


def make_optimizer(lr: float, weight_decay: float = 1e-5, warmup_steps: int = 500,
                   total_steps: int = 200_000, clip_grad_norm: float = 0.0,
                   use_adabelief: bool = False, use_adamw: bool = False, amsgrad: bool = False):
    schedule = second_stage_schedule(lr, warmup_steps, total_steps)
    if use_adabelief:
        steps = [_ScaleByBelief(), _ScaleBySchedule(schedule)]
    elif use_adamw:
        steps = [_ScaleByAdam(), _DecayedWeights(weight_decay), _ScaleBySchedule(schedule)]
    else:
        steps = torch_adam(schedule, weight_decay=weight_decay, amsgrad=amsgrad)
    if clip_grad_norm > 0:
        steps = [_Clip(clip_grad_norm)] + steps
    return Optimizer(steps)


class TrainState(NamedTuple):
    step: int
    params: dict          # trainable subtree
    opt_state: list


def init_state(params_trainable, optimizer: Optimizer) -> TrainState:
    """The first state; the float leaves of ``params_trainable`` are set to
    require gradients and are updated in place by the steps."""
    for p in float_leaves(params_trainable):
        p.requires_grad_(True)
    return TrainState(0, params_trainable, optimizer.init(params_trainable))


def apply_updates(optimizer: Optimizer, state: TrainState, grads):
    """One optimizer update of ``state``'s params, in place, from ``grads``
    (a list over its float leaves)."""
    p = float_leaves(state.params)
    with torch.no_grad():
        torch._foreach_add_(p, optimizer.update(grads, state.opt_state, p))


def make_train_step(spec, frozen_params, optimizer: Optimizer, spatial_mean: bool = False,
                    logdet_weight: float = 1.0, n_microbatches: int = 1, compute_dtype=None):
    """``train_step(state, batch, rng) -> (state, metrics)``; ``rng`` is a
    JAX key (``utils/prng``).

    batch['images']: (B, T, S, S, 3); batch['poke']: (B, S, S, 2).  With
    ``n_microbatches`` > 1 the batch is split along axis 0, microbatch i
    takes key i of ``split(rng, n)``, and the gradients are averaged; the
    metrics are the last microbatch's logs and ``grad_norm``, the global norm
    of the gradients before clipping.  ``compute_dtype`` (e.g.
    ``torch.bfloat16``): the forward runs in that dtype on casts of the f32
    params, so the gradients come back in f32; logdet and NLL sum in f32.
    """
    policy = Policy(compute_dtype) if compute_dtype is not None else None

    def grads_of(trainable, micro, rng):
        params = {**frozen_params, **trainable}
        if policy is not None:
            params, micro = policy.cast(params), policy.cast(micro)
        out, logdet, _ = second_stage.forward_density(params, spec, micro)
        loss, logs = flow_loss(out, logdet, key=rng, spatial_mean=spatial_mean,
                               logdet_weight=logdet_weight)
        p = float_leaves(trainable)
        grads = torch.autograd.grad(loss, p, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(p, grads)]
        return loss.detach(), {k: v.detach() for k, v in logs.items()}, grads

    def train_step(state: TrainState, batch, rng):
        n = n_microbatches
        if n > 1:
            grads = None
            for i, key in enumerate(prng.split(rng, n)):
                micro = {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))[i]
                         for k, v in batch.items()}
                _, logs, g = grads_of(state.params, micro, key)
                if grads is None:
                    grads = g
                else:
                    torch._foreach_add_(grads, g)
            torch._foreach_div_(grads, n)
        else:
            _, logs, grads = grads_of(state.params, batch, rng)
        metrics = dict(logs, grad_norm=global_norm(grads))
        apply_updates(optimizer, state, grads)
        return TrainState(state.step + 1, state.params, state.opt_state), metrics

    return train_step
