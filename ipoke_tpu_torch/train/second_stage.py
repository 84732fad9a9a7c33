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
averaged.  ``shard_train_setup`` runs a step over a ``parallel/mesh`` of
processes: data parallel, ZeRO-1, FSDP and tensor parallel.
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


def global_norm(tensors):
    """optax.global_norm: the L2 norm of all elements of all tensors."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


# ---------------------------------------------------------------------------
# gradient transformations: init(params) -> state dict;
# update(updates, state, params) -> updates, each a list over the float leaves
# ---------------------------------------------------------------------------

class _Clip:
    """optax.clip_by_global_norm: ``t / norm * max_norm`` when norm >= max_norm.
    ``norm``: the global norm of the updates it is given (a sharded step's
    sums the squares of every rank's slices)."""
    name = "clip"

    def __init__(self, max_norm, norm=global_norm):
        self.max_norm = max_norm
        self.norm = norm

    def init(self, params):
        return {}

    def update(self, updates, state, params):
        g_norm = self.norm(updates).item()
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
    then count + 1.  ``counted=False``: a constant lr, for which optax keeps
    no count (``scale(-lr)``); the port counts all the same."""
    name = "schedule"

    def __init__(self, schedule, counted=True):
        self.schedule = schedule
        self.counted = counted

    def init(self, params):
        return {"count": 0}

    def update(self, updates, state, params):
        lr = self.schedule(state["count"])
        state["count"] += 1
        return torch._foreach_mul(updates, -lr)


class Optimizer:
    """A chain of gradient transformations over a param tree's float leaves
    (``make_optimizer``'s result).

    ``layout`` nests the transforms' indices as optax's chains nest their
    states (a chain inside a chain is a tuple inside the tuple; default: one
    flat chain); ``masked``: optax wraps the chain in ``multi_transform``
    with the frozen leaves ``set_to_zero``.  Both say only how the state is
    saved (``ckpt/optax_layout``)."""

    def __init__(self, transforms, layout=None, masked=True):
        self.transforms = list(transforms)
        self.layout = tuple(range(len(self.transforms))) if layout is None else layout
        self.masked = masked

    def init(self, params_tree):
        p = float_leaves(params_tree)
        return [t.init(p) for t in self.transforms]

    def update(self, grads, state, params):
        """Updates for the float leaves ``params`` from their ``grads``."""
        for t, s in zip(self.transforms, state):
            grads = t.update(grads, s, params)
        return grads

    def with_norm(self, norm):
        """This chain with ``norm`` as clip_by_global_norm's global norm."""
        return Optimizer([_Clip(t.max_norm, norm) if isinstance(t, _Clip) else t
                          for t in self.transforms], self.layout, self.masked)


def torch_adam(schedule, weight_decay: float = 0.0, amsgrad: bool = False,
               b1: float = 0.9, b2: float = 0.999):
    """torch.optim.Adam semantics: coupled L2 (``wd * param`` added to the
    gradient before the moments), optional amsgrad; the reference's optimizer."""
    steps = [_DecayedWeights(weight_decay)] if weight_decay else []
    steps.append((_ScaleByTorchAmsgrad if amsgrad else _ScaleByAdam)(b1, b2))
    return steps + [_ScaleBySchedule(schedule)]


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, masked: bool = False) -> Optimizer:
    """optax.adam(lr): scale_by_adam, then a constant scale of -lr; no decay
    (the distillation experiment's optimizer; ``masked``: under
    ``multi_transform``, as JAX wraps it for a flow student)."""
    return Optimizer([_ScaleByAdam(b1, b2), _ScaleBySchedule(lambda count: lr, counted=False)],
                     masked=masked)


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
    if clip_grad_norm > 0:   # optax.chain(clip, <the chain above>)
        return Optimizer([_Clip(clip_grad_norm)] + steps,
                         layout=(0, tuple(range(1, len(steps) + 1))))
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

    The step passes its key to ``forward_density`` too, which draws the
    augment channels of ``augmented_input`` from it, as JAX's step does.

    The step carries what ``shard_train_setup`` builds its own from:
    ``grads_of(trainable, batch, rng, rows=None)`` -> (loss, logs, gradients
    of the float leaves), without the reference NLL when ``rows`` (this
    process's rows of the global batch, ``forward_density``'s) is given, and
    the settings it was made with.
    """
    policy = Policy(compute_dtype) if compute_dtype is not None else None

    def grads_of(trainable, micro, rng, rows=None):
        params = {**frozen_params, **trainable}
        if policy is not None:
            params, micro = policy.cast(params), policy.cast(micro)
        out, logdet, _ = second_stage.forward_density(params, spec, micro, rng=rng, rows=rows)
        loss, logs = flow_loss(out, logdet, key=None if rows else rng, spatial_mean=spatial_mean,
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

    train_step.grads_of = grads_of
    train_step.spec, train_step.optimizer = spec, optimizer
    train_step.spatial_mean, train_step.n_microbatches = spatial_mean, n_microbatches
    return train_step


# ---------------------------------------------------------------------------
# the step over a mesh of processes
# ---------------------------------------------------------------------------

class _Leaf(NamedTuple):
    """Where a float leaf lives on the mesh: ``store`` the placement of the
    param between steps (tensor parallel over ``model``, FSDP over
    ``data``), ``zero`` the placement over ``data`` of its moments and of
    the slice of it this rank updates."""
    store: object
    zero: object


def _with_float_leaves(tree, new):
    """``tree`` with its float leaves replaced, in order, by ``new``."""
    it = iter(new)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return next(it) if t is not None and t.is_floating_point() else t

    out = walk(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _sum_in_buckets(tensors, group, bucket_bytes=1 << 26):
    """Sum every tensor over ``group`` in place, a few flattened buckets per
    all-reduce."""
    import torch.distributed as dist

    bucket, size = [], 0

    def flush():
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        torch._foreach_copy_(bucket, [c.view_as(t) for c, t in
                                      zip(flat.split([t.numel() for t in bucket]), bucket)])

    for t in tensors:
        if bucket and (t.dtype != bucket[0].dtype or size + t.nbytes > bucket_bytes):
            flush()
            bucket, size = [], 0
        bucket.append(t)
        size += t.nbytes
    if bucket:
        flush()


def shard_train_setup(mesh, state: TrainState, step_fn, param_shardings=None,
                      zero_opt: bool = True, donate: bool = True, zero_min_size: int = 8192,
                      fsdp: bool = False):
    """Place ``state`` on ``mesh`` (``parallel/mesh.make_mesh``, one process
    per place) and build the step that trains it there.

    Every process calls this with the same ``state`` (the one-process
    ``init_state``, or a restored one) and ``step_fn`` (``make_train_step``'s
    result).  Returns ``(placed_state, step)`` with ``step(state,
    local_batch, rng) -> (state, metrics)``: ``local_batch`` is this rank's
    rows of the global batch (``mesh.shard_batch``), ``rng`` the same key on
    every rank, and the metrics those of the one-process step on the global
    batch: the losses averaged over ``data``, the reference NLL of the
    global batch's draw, ``grad_norm`` the norm of the whole gradient.

    * data parallel: each rank's gradients of its rows, averaged over
      ``data`` by an all-reduce;
    * ``param_shardings`` (tensor parallel, ``parallel/sharding.
      flow_param_shardings``): a leaf placed on ``model`` is held, computed
      and updated as this rank's shard (the NICE blocks of the flow's priors
      run split, ``flows/convnets.model_parallel``);
    * ``zero_opt`` (ZeRO-1): the moments of every leaf that
      ``zero_opt_state_shardings`` places are this rank's slice over
      ``data``; each rank updates its slice of the param, then the slices are
      all-gathered;
    * ``fsdp``: every leaf ``fsdp_param_shardings`` places on ``data`` (a
      tensor-parallel placement wins) is held as this rank's slice between
      steps and all-gathered, whole, at the start of each step; its gradient
      is averaged and sliced again (an all-reduce, then a slice).

    ``clip_by_global_norm`` and ``grad_norm`` sum the squares of every
    rank's slices.  The step updates ``placed_state`` in place, as JAX's
    donated step reuses its buffers; with ``donate=False`` the placed state
    is a copy and ``state`` stays as it was.  ``step.full_params(state)``
    gathers the whole trainable tree on every rank.
    """
    import torch.distributed as dist

    from ipoke_tpu_torch.ckpt.jax_bridge import grown_adapters
    from ipoke_tpu_torch.flows import convnets, transformer
    from ipoke_tpu_torch.flows.loss import nll
    from ipoke_tpu_torch.parallel import distributed as pdist
    from ipoke_tpu_torch.parallel import sharding as psh
    from ipoke_tpu_torch.parallel.mesh import axis_index, axis_size, group

    if not hasattr(step_fn, "grads_of"):
        raise TypeError("shard_train_setup takes a step made by make_train_step")
    if step_fn.n_microbatches > 1:
        raise NotImplementedError("microbatches in a step over a mesh")
    spec = step_fn.spec
    transposed = tuple(grown_adapters(spec))
    n_data, n_model = axis_size(mesh, "data"), axis_size(mesh, "model")
    groups = {axis: group(mesh, axis) for axis in ("data", "model")}
    store_tree = param_shardings
    if fsdp:
        store_tree = psh.fsdp_param_shardings(mesh, state.params, min_size=zero_min_size,
                                              tp_shardings=param_shardings,
                                              transposed=transposed)
    zero_tree = (psh.zero_opt_state_shardings(mesh, state.params, min_size=zero_min_size,
                                              transposed=transposed) if zero_opt else None)
    all_leaves = leaves(state.params)

    def float_placements(tree):
        if tree is None:
            return [None] * len(float_leaves(state.params))
        return [p for t, p in zip(all_leaves, psh.placements(tree))
                if t is not None and t.is_floating_point()]

    plans = [_Leaf(store, zero) for store, zero in
             zip(float_placements(store_tree), float_placements(zero_tree))]
    on_model = [p.store is not None and p.store.axis == "model" for p in plans]
    on_data = [p.store is not None and p.store.axis == "data" for p in plans]

    def chunk(t, split):
        return t if split is None else pdist.chunk(t, split.dim, groups[split.axis])

    def gather(t, split):
        return t if split is None else pdist.gather_cat(t, split.dim, groups[split.axis])

    # the placed state: stored params, moments on the update slices
    full = float_leaves(state.params)
    n_float = len(full)
    stored = []
    for t, p, fs in zip(full, plans, on_data):
        s = chunk(t.detach(), p.store)
        s = s.clone() if (p.store is not None or not donate) else s
        stored.append(s.requires_grad_(not fs))
    params = _with_float_leaves(state.params, stored)

    def moment_view(m, p, tp):
        return chunk(chunk(m, p.store) if tp else m, p.zero).clone()

    opt_state = []
    for s in state.opt_state:
        s = dict(s)
        for k, v in s.items():
            if isinstance(v, list) and len(v) == n_float:
                s[k] = [moment_view(m, p, tp) for m, p, tp in zip(v, plans, on_model)]
        opt_state.append(s)

    # the whole gradient's norm: each leaf's squares counted once over the mesh
    weights = [(1.0 if p.zero is not None else 1.0 / n_data) * (1.0 if tp else 1.0 / n_model)
               for p, tp in zip(plans, on_model)]

    def norm(tensors):
        sq = torch.stack(torch._foreach_norm(tensors)).float().square()
        total = (sq * torch.tensor(weights, device=sq.device)).sum()
        dist.all_reduce(total)
        return total.sqrt()

    optimizer = step_fn.optimizer.with_norm(norm)

    def step(st: TrainState, local_batch, rng):
        mine = float_leaves(st.params)
        compute = [gather(t, p.store).requires_grad_(True) if fs else t
                   for t, p, fs in zip(mine, plans, on_data)]
        tree = _with_float_leaves(st.params, compute)
        b_local = next(iter(local_batch.values())).shape[0]
        mine_rows = (axis_index(mesh, "data") * b_local, b_local * n_data)
        if any(on_model):
            with convnets.model_parallel(groups["model"]):
                _, logs, grads = step_fn.grads_of(tree, local_batch, rng, mine_rows)
        else:
            _, logs, grads = step_fn.grads_of(tree, local_batch, rng, mine_rows)
        if n_data > 1:
            _sum_in_buckets(grads, groups["data"])
            torch._foreach_div_(grads, n_data)
            names = ("flow_loss", "nlogdet_loss", "nll_loss")
            losses = pdist.sum_(torch.stack([logs[k] for k in names]), groups["data"]) / n_data
            logs = dict(logs, **dict(zip(names, losses.unbind())))
        shape = transformer.reverse_input_shape(spec.flow, mine_rows[1], spec.latent_size,
                                                spec.flow_in_channels)
        ref = prng.normal(rng, shape, logs["flow_loss"].device)
        logs["reference_nll_loss"] = nll(ref, step_fn.spatial_mean).mean()
        g_mine = [chunk(g, p.zero) for g, p in zip(grads, plans)]
        metrics = dict(logs, grad_norm=norm(g_mine))
        with torch.no_grad():
            p_mine = [chunk(c, p.zero) for c, p in zip(compute, plans)]
            torch._foreach_add_(p_mine, optimizer.update(g_mine, st.opt_state, p_mine))
            for t, c, u, p, fs in zip(mine, compute, p_mine, plans, on_data):
                if fs:
                    t.copy_(chunk(c, p.store))
                elif p.zero is not None:
                    c.copy_(gather(u, p.zero))
        return TrainState(st.step + 1, st.params, st.opt_state), metrics

    def local_view(i, whole, moment=False):
        """This rank's piece of float leaf ``i`` given whole (or, with
        ``moment``, of one of its moments), as the placed state holds it."""
        if moment:
            return moment_view(whole, plans[i], on_model[i])
        return chunk(whole, plans[i].store)

    def full_params(st: TrainState):
        return _with_float_leaves(st.params, [gather(t.detach(), p.store) for t, p in
                                              zip(float_leaves(st.params), plans)])

    step.full_params, step.local_view, step.plans = full_params, local_view, plans
    return TrainState(state.step, params, opt_state), step
