"""Sampling-time flow distillation (counterpart of ``ipoke_tpu/train/distill.py``).

A student replaces the teacher's sequential flow reverse (200 MaCowUnit
inverses, kernel K2, per call at iper_128); the first stage and the
conditioning towers stay the teacher's, frozen.  Two families:

* ``DirectStudentSpec``: a feedforward conv sampler ``(z, cond) -> motion``
  (conv-in, group-norm residual blocks, conv-out), fitted by MSE to the
  teacher's reverse output.  Sampling runs no MCF inverse at all.
* ``flow_student_spec``: the teacher's FlowSpec with fewer MaCowSteps per
  level, fitted by maximum likelihood on the teacher's samples through its
  parallel forward; its reverse runs 4 K2 launches per step.

The frozen teacher's reverse runs under ``torch.no_grad`` (JAX's
``stop_gradient``) through the spec's MCF backend, K2 by default.  The
optimizer is optax's ``adam`` (``train/second_stage.adam``) on the
student's float leaves; a flow student's integer shuffle permutations are
no optimizer leaves and stay as initialised.  Keys are JAX keys
(``utils/prng``), so ``init_direct`` and a flow student's init draw JAX's
params.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch

from ipoke_tpu_torch import resolve_device
from ipoke_tpu_torch.flows import transformer
from ipoke_tpu_torch.flows.loss import flow_loss
from ipoke_tpu_torch.models import second_stage
from ipoke_tpu_torch.nn import blocks
from ipoke_tpu_torch.nn.core import depth_to_space, space_to_depth
from ipoke_tpu_torch.train.second_stage import float_leaves
from ipoke_tpu_torch.utils import prng


@dataclass(frozen=True)
class DirectStudentSpec:
    """Feedforward sampler: conv-in -> N residual blocks -> conv-out."""

    hidden: int = 256
    depth: int = 6
    kind: str = "direct"


def flow_student_spec(teacher_flow, num_steps: Tuple[int, ...]):
    """An invertible student: the teacher's FlowSpec with fewer steps per
    level, so it reads the same cond and gives the same motion geometry.
    A MultiscaleStack teacher raises ``ValueError``, as in JAX."""
    if transformer.is_stack(teacher_flow):
        raise ValueError("flow students of a MultiscaleStack teacher are not supported; "
                         "distill each block or use a plain FlowSpec teacher")
    if len(num_steps) != len(teacher_flow.num_steps):
        raise ValueError(
            f"student must keep the teacher's level count "
            f"({len(teacher_flow.num_steps)}), got {len(num_steps)}")
    return replace(teacher_flow, num_steps=tuple(num_steps))


# ---------------------------------------------------------------------------
# Direct student network
# ---------------------------------------------------------------------------

def init_direct(key, spec, ds: DirectStudentSpec, device=None):
    """JAX's ``init_direct``: each block from its own subkey of
    ``split(key, depth + 2)``, on ``device`` (the CUDA card by default)."""
    device = resolve_device(device)
    c_z, c_h = spec.flow_in_channels, spec.h_channels
    ks = prng.split(key, ds.depth + 2)
    return {
        "conv_in": blocks.init_conv2d_block(ks[0], c_z + c_h, ds.hidden, 3, device=device),
        "res": [blocks.init_res_block(ks[i + 1], ds.hidden, ds.hidden, norm="group", device=device)
                for i in range(ds.depth)],
        "conv_out": blocks.init_conv2d_block(ks[-1], ds.hidden, spec.flow_in_channels, 3,
                                             device=device),
    }


def _z_at_motion_geometry(flow_spec, z):
    """The Gaussian draw (at ``transformer.reverse_input_shape``, a stack's
    reshaped geometry) at the motion latent's geometry, where the direct
    student works."""
    if transformer.is_stack(flow_spec) and flow_spec.reshape == "down":
        return depth_to_space(z, 2)
    if transformer.is_stack(flow_spec) and flow_spec.reshape == "up":
        return space_to_depth(z, 2)
    return z


def direct_apply(p, ds: DirectStudentSpec, z, cond):
    x = torch.cat([z, cond.to(z.dtype)], dim=-1)
    x = blocks.conv2d_block_apply(p["conv_in"], x, padding=1, act="elu")
    for rp in p["res"]:
        x = blocks.res_block_apply(rp, x, norm="group")
    return blocks.conv2d_block_apply(p["conv_out"], x, padding=1, act="none")


# ---------------------------------------------------------------------------
# Teacher sampling (frozen)
# ---------------------------------------------------------------------------

@torch.no_grad()
def teacher_motion(params, spec, z, cond):
    """One frozen teacher reverse pass: the target motion latent."""
    return transformer.reverse(params["flow"], spec.flow, z, cond)


# ---------------------------------------------------------------------------
# Losses + train steps
# ---------------------------------------------------------------------------

def direct_loss(student_params, ds, params, spec, z, cond):
    """MSE of the student to the teacher over the examples whose teacher
    motion is finite.  The mask goes on the teacher target before the
    subtraction, so no 0 * NaN reaches the gradients; a batch with no finite
    teacher example gives NaN, not 0."""
    m_t = teacher_motion(params, spec, z, cond).float()
    m_s = direct_apply(student_params, ds, _z_at_motion_geometry(spec.flow, z), cond)
    reduce_dims = tuple(range(1, m_t.dim()))
    finite_el = torch.isfinite(m_t)
    finite = finite_el.flatten(1).all(dim=1)   # (B,)
    m_t_safe = torch.where(finite_el, m_t, torch.zeros_like(m_t))
    per_ex = ((m_s.float() - m_t_safe) ** 2).mean(dim=reduce_dims)
    n_finite = finite.sum()
    mse = (per_ex * finite).sum() / n_finite.clamp(min=1)
    mse = torch.where(n_finite > 0, mse, torch.full_like(mse, float("nan")))
    return mse, {"distill_mse": mse, "teacher_finite_frac": finite.float().mean()}


def flow_student_loss(student_params, s_spec, params, spec, z, cond):
    """MLE of the student on teacher samples (parallel forward only)."""
    m_t = teacher_motion(params, spec, z, cond)
    out, logdet = transformer.forward(student_params, s_spec, m_t, cond)
    return flow_loss(out, logdet)


def make_distill_step(spec, student, optimizer):
    """Returns ``(init_state, step)``.

    ``init_state(key, device=None) -> {'params', 'opt', 'step'}``: the
    student drawn from the JAX key ``key``, its float leaves set to require
    gradients.  ``step(state, teacher_params, z, cond) -> (state, logs)``
    updates the student in place by one ``optimizer`` step
    (``train/second_stage.Optimizer``, e.g. ``adam(lr)``).  The frozen
    teacher is an argument of the step, not a closure.  ``student`` is a
    DirectStudentSpec or a student FlowSpec (``flow_student_spec``).
    """
    is_direct = isinstance(student, DirectStudentSpec)

    def loss_fn(sp, teacher_params, z, cond):
        if is_direct:
            return direct_loss(sp, student, teacher_params, spec, z, cond)
        return flow_student_loss(sp, student, teacher_params, spec, z, cond)

    def init_state(key, device=None):
        device = resolve_device(device)
        sp = init_direct(key, spec, student, device) if is_direct \
            else transformer.init(key, student, device)
        for p in float_leaves(sp):
            p.requires_grad_(True)
        return {"params": sp, "opt": optimizer.init(sp), "step": 0}

    def step(state, teacher_params, z, cond):
        sp = state["params"]
        loss, logs = loss_fn(sp, teacher_params, z, cond)
        p = float_leaves(sp)
        grads = torch.autograd.grad(loss, p, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(p, grads)]
        with torch.no_grad():
            torch._foreach_add_(p, optimizer.update(grads, state["opt"], p))
        logs = {k: v.detach() for k, v in logs.items()}
        return ({"params": sp, "opt": state["opt"], "step": state["step"] + 1},
                {**logs, "loss": loss.detach()})

    return init_state, step


# ---------------------------------------------------------------------------
# Student sampling path (mirrors second_stage.forward_sample)
# ---------------------------------------------------------------------------

@torch.no_grad()
def forward_sample_student(params, student_params, student, spec, batch, rng=None,
                           n_samples: int = 1, length: Optional[int] = None,
                           add_first_frame: bool = False, z: Optional[torch.Tensor] = None):
    """The teacher's embed and decode with the student in place of the flow
    reverse: (n_samples, B, T, S, S, 3), the contract of
    ``second_stage.forward_sample``.  ``z`` fixes the draw (shape
    ``reverse_input_shape(...)`` of the student's flow, or with a leading
    samples axis); else sample i draws ``prng.normal(keys[i], z_shape)`` with
    ``keys = prng.split(rng, n_samples)``, JAX's draw.  The samples are
    folded into the batch axis."""
    is_direct = isinstance(student, DirectStudentSpec)
    x = batch["images"]
    poke = batch["flow"] if spec.use_flow_as_poke else batch["poke"]
    x0 = x[:, 0]
    b = x.shape[0]
    if length is None:
        length = x.shape[1] - 1
    flow_spec = spec.flow if is_direct else student
    z_shape = transformer.reverse_input_shape(flow_spec, b, spec.latent_size, spec.flow_in_channels)
    if z is None:
        if rng is None:
            raise ValueError("forward_sample_student needs a fixed z or a JAX key rng")
        z = torch.stack([prng.normal(k, z_shape, x.device) for k in prng.split(rng, n_samples)])
    elif z.dim() == len(z_shape):
        z = z[None]
    n = z.shape[0]
    cond = second_stage.embed_cond(params, spec, x0, poke)

    def rep(t):  # (B, ...) -> (n*B, ...), sample-major like z
        return t.unsqueeze(0).expand((n,) + tuple(t.shape)).reshape((n * b,) + tuple(t.shape[1:]))

    zz = z.to(x.dtype).reshape((n * b,) + tuple(z_shape[1:]))
    if is_direct:
        motion = direct_apply(student_params, student, _z_at_motion_geometry(spec.flow, zz),
                              rep(cond))
    else:
        motion = transformer.reverse(student_params, student, zz, rep(cond))
    if spec.augment_channels:
        motion = motion[..., :-spec.augment_channels]
    x0r = rep(x0)
    vid = second_stage.decode_first_stage(params, spec, motion, x0r, length)
    if add_first_frame:
        vid = torch.cat([x0r[:, None], vid], dim=1)
    return vid.reshape((n, b) + tuple(vid.shape[1:]))
