"""Leapfrog (HMC-style) augmented flows (counterpart of
``ipoke_tpu/flows/leapfrog.py``); unused by the released configs.

A coupling evolves (x, v) by symplectic integrator steps:
    v' = v - dt/2 * grad_u(x);  x' = x + dt * p(v');  v'' = v' - dt/2 * grad_u(x')
Each sub-update is a shear, so the coupling has logdet 0 and is inverted by
undoing the shears in reverse order.  As in the JAX package this is the
intended semantics: the reference's reverse pass evaluates grad_u at the
not yet recovered x and so does not invert its forward.  Blocks wrap the
coupling in a vector ActNorm and a Shuffle per variable.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ipoke_tpu_torch.flows import permute
from ipoke_tpu_torch.flows.legacy import (
    fc_net_apply,
    init_fc_net,
    init_vec_actnorm,
    vec_actnorm_forward,
    vec_actnorm_inverse,
)
from ipoke_tpu_torch.utils import prng


@dataclass(frozen=True)
class LeapFlowSpec:
    in_channels: int
    hidden_dim: int
    hidden_depth: int = 2
    n_flows: int = 2
    delta_t: float = 1.0
    n_leap_steps: int = 2   # grad_u / scale_p pairs per coupling


def init_coupling(key, spec: LeapFlowSpec, device="cpu"):
    c = spec.in_channels
    net = lambda i, tanh: init_fc_net(prng.fold_in(key, i), c, spec.hidden_depth,  # noqa: E731
                                      spec.hidden_dim, c, tanh, device)
    return {"grad_u": [net(i, True) for i in range(spec.n_leap_steps)],
            "scale_p": [net(100 + i, False) for i in range(spec.n_leap_steps)]}


def coupling_forward(p, x, v, spec: LeapFlowSpec):
    dt = spec.delta_t
    for i in range(spec.n_leap_steps):
        v = v - 0.5 * dt * fc_net_apply(p["grad_u"][i], x)
        x = x + dt * fc_net_apply(p["scale_p"][i], v)
        v = v - 0.5 * dt * fc_net_apply(p["grad_u"][i], x)
    return x, v, torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)


def coupling_inverse(p, x, v, spec: LeapFlowSpec):
    dt = spec.delta_t
    for i in reversed(range(spec.n_leap_steps)):
        v = v + 0.5 * dt * fc_net_apply(p["grad_u"][i], x)
        x = x - dt * fc_net_apply(p["scale_p"][i], v)
        v = v + 0.5 * dt * fc_net_apply(p["grad_u"][i], x)
    return x, v


def init_leap_flow(key, spec: LeapFlowSpec, device="cpu"):
    c = spec.in_channels
    blocks = []
    for i in range(spec.n_flows):
        kk = prng.fold_in(key, i)
        blocks.append({
            "actnorm_x": init_vec_actnorm(c, device),
            "actnorm_v": init_vec_actnorm(c, device),
            "coupling": init_coupling(prng.fold_in(kk, 1), spec, device),
            "shuffle_x": permute.init_shuffle(prng.fold_in(kk, 2), c, device),
            "shuffle_v": permute.init_shuffle(prng.fold_in(kk, 3), c, device),
        })
    return {"blocks": blocks}


def leap_flow_forward(p, spec: LeapFlowSpec, x, v):
    """x, v: (B, C).  Returns (x', v', logdet)."""
    logdet = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
    for blk in p["blocks"]:
        x, ld = vec_actnorm_forward(blk["actnorm_x"], x)
        logdet = logdet + ld
        v, ld = vec_actnorm_forward(blk["actnorm_v"], v)
        logdet = logdet + ld
        x, v, ld = coupling_forward(blk["coupling"], x, v, spec)
        logdet = logdet + ld
        x, _ = permute.shuffle_forward(blk["shuffle_x"], x)
        v, _ = permute.shuffle_forward(blk["shuffle_v"], v)
    return x, v, logdet


def leap_flow_inverse(p, spec: LeapFlowSpec, x, v):
    for blk in reversed(p["blocks"]):
        x = permute.shuffle_inverse(blk["shuffle_x"], x)
        v = permute.shuffle_inverse(blk["shuffle_v"], v)
        x, v = coupling_inverse(blk["coupling"], x, v, spec)
        x = vec_actnorm_inverse(blk["actnorm_x"], x)
        v = vec_actnorm_inverse(blk["actnorm_v"], v)
    return x, v


def hmc_sample(p, spec: LeapFlowSpec, key, x0):
    """Momenta ~ N(0, I) from the JAX key ``key``, the flow run forward:
    the evolved (positions, momenta)."""
    v0 = prng.normal(key, tuple(x0.shape), x0.device).to(x0.dtype)
    x1, v1, _ = leap_flow_forward(p, spec, x0, v0)
    return x1, v1
